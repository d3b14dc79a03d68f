"""The port's Philox4x32-10 sampler (vae_training_tpu_torch/ops/rng.py).

Known-answer vectors from the Random123 distribution, a bitwise check of the
int64 word arithmetic against a plain uint64 numpy implementation, the
exact uniform map, the Box-Muller moments, and the counter properties the
training path relies on (chunk-independent, resume-exact streams).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.data import LinearGaussianDataset  # noqa: E402
from vae_training_tpu_torch.ops import rng  # noqa: E402

M32 = 0xFFFFFFFF


def _t(v):
    return torch.tensor(v, dtype=torch.int64)


# Random123 kat_vectors: philox4x32 with 10 rounds
@pytest.mark.parametrize("ctr,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expected):
    out = rng.philox4x32(*(_t(c) for c in ctr), *key)
    assert tuple(int(w) for w in out) == expected


def _philox_numpy(c, k0, k1):
    """Reference Philox4x32-10 on uint64 arrays (products fit 64 bits)."""
    c = [np.asarray(x, np.uint64) for x in c]
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    mask = np.uint64(M32)
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & M32
            k1 = (k1 + 0xBB67AE85) & M32
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & mask]
    return c


@pytest.mark.parametrize("seed", [0, 1, 2**63 + 12345, 2**64 - 1])
def test_words_match_uint64_reference(seed):
    step, rows, n_draws, stream = 987654, 37, 5, rng.STREAM_Z2
    w = rng.words(seed, step, rows, stream, n_draws).numpy()
    k0, k1 = rng.key_words(seed)
    r, d = np.meshgrid(np.arange(rows), np.arange(n_draws), indexing="ij")
    ref = _philox_numpy([np.full_like(r, step), r, d, np.full_like(r, stream)], k0, k1)
    np.testing.assert_array_equal(w, np.stack(ref, axis=-1).astype(np.int64))


def test_uniform_map_is_exact_and_never_zero():
    w = torch.tensor([0, 255, 256, M32, 0x80000000], dtype=torch.int64)
    u = rng.uniforms(w).numpy()
    expected = ((np.array([0, 0, 1, M32 >> 8, 0x800000], np.float64) + 0.5)
                / 2.0**24).astype(np.float32)
    np.testing.assert_array_equal(u, expected)
    # never 0 (log-safe); the top 24-bit value rounds to 1.0 in float32,
    # as it does in the TPU kernel's _uniform
    assert u.min() > 0.0 and u.max() == 1.0


def test_normal_moments_and_partner_correlation():
    # 1M normals: |mean|, |std - 1| and the cos/sin partner correlation are
    # each ~1e-3 at 1 sigma; 5e-3 bounds are > 4 sigma
    w = rng.words(20240601, 3, 4096, rng.STREAM_MANIFOLD, 64)
    n = rng.box_muller(w).reshape(-1, 4).double()
    flat = n.reshape(-1)
    assert abs(flat.mean().item()) < 5e-3
    assert abs(flat.std().item() - 1.0) < 5e-3
    for a, b in ((0, 1), (2, 3), (0, 2)):
        rho = torch.corrcoef(torch.stack([n[:, a], n[:, b]]))[0, 1].item()
        assert abs(rho) < 5e-3, (a, b, rho)


def test_streams_are_counter_keyed():
    a = rng.normals(7, 100, 8, rng.STREAM_Z1, 20)
    np.testing.assert_array_equal(a, rng.normals(7, 100, 8, rng.STREAM_Z1, 20))
    # a wider draw extends the narrower one: normal k of a row never
    # depends on how many the caller asked for
    np.testing.assert_array_equal(a[:, :6], rng.normals(7, 100, 8, rng.STREAM_Z1, 6))
    # rows are independent of the row count
    np.testing.assert_array_equal(a[:3], rng.normals(7, 100, 3, rng.STREAM_Z1, 20))
    for other in (rng.normals(7, 101, 8, rng.STREAM_Z1, 20),
                  rng.normals(8, 100, 8, rng.STREAM_Z1, 20),
                  rng.normals(7, 100, 8, rng.STREAM_Z2, 20)):
        assert not torch.equal(a, other)
    seeds = {rng.derive_seed(s, p) for s in (0, 1, 2) for p in range(1, 6)}
    assert len(seeds) == 15


@pytest.mark.parametrize("var_added", [0.0, 0.25])
def test_linear_dataset_sample(var_added):
    ds = LinearGaussianDataset.create(2, dimension=3, intrinsic_dimension=3,
                                      padding_dimension=9, var_added=var_added)
    assert ds.A.shape == (3, 3) and int(np.linalg.matrix_rank(ds.A.numpy())) == 3
    x = ds.sample(11, 5, 64)
    lat = rng.normals(11, 5, 64, rng.STREAM_MANIFOLD, 3)
    expected = torch.nn.functional.pad(lat @ ds.A.T, (0, 9))
    if var_added:
        expected = expected + rng.normals(11, 5, 64, rng.STREAM_OBS, 12) * np.sqrt(var_added)
        assert ds.score(x)["Squared Norm of padding dimensions"] > 0
    else:
        assert float(ds.score(x)["Squared Norm of padding dimensions"]) == 0.0
    np.testing.assert_allclose(x.numpy(), expected.numpy(), rtol=1e-6, atol=1e-6)
