"""K1, K2, K5, K5-dual, K6a and K6b on the card: the CUDA kernels against
their plain PyTorch versions, and the grid modes' rows against the solo
kernels.

These tests need a CUDA device of compute capability 9.0 and nvcc; they
carry the ``cuda`` marker and skip elsewhere. The file imports no JAX, so on
a machine without it run them with the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are those of tests/test_pallas_kernel.py for K1, K2 and K6a and
of tests/test_mlp_kernel.py for K5, K5-dual and K6b: both sides are fp32,
and only summation order and libm ulps differ (the MLP kernel's 200-term
sums through four layers each way compound more of them).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.data import (  # noqa: E402
    LinearGaussianDataset,
    SigmoidDataset,
    SphereDataset,
)
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.kernels import mlp_vae as k5  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.ops import rng  # noqa: E402
from vae_training_tpu_torch.train import TrainState  # noqa: E402

D, L, ID, B = 12, 20, 3, 100


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if torch.cuda.get_device_capability() != k1.CAPABILITY:
        pytest.skip("needs an sm_90 device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flat_state(device, tdv):
    model = build_vae(data_dim=D, latent_dim=L, epsilon=-1.0, tunable_decoder_var=tdv)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2).to(device)
    return k1.pack_state(state, D, L)


def _chunk(p, m, v, a, n, step0, tdv, noise=None, plain=False):
    fn = k1.plain_fused_chunk if plain else k1.run_fused_chunk
    return fn(p, m, v, a, n_steps=n, batch=B, data_dim=D, latent_dim=L,
              intrinsic_dim=ID, manifold_dim=ID, step0=step0, t0=step0,
              data_seed=rng.derive_seed(2, 1), model_seed=rng.derive_seed(0, 3),
              var_added=0.0, eps_const=-1.0, tdv=tdv, lr=1e-3, external_noise=noise)


@pytest.mark.cuda
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("tdv", [True, False])
def test_kernel_matches_plain(cuda_device, tdv, external):
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=cuda_device)
    n = 32
    noise = None
    if external:
        rs = np.random.RandomState(0)
        xs = np.zeros((n, B, D), np.float32)
        xs[:, :, :3] = rs.randn(n, B, 3).astype(np.float32) @ ds.A.cpu().numpy().T
        noise = tuple(torch.as_tensor(a, device=cuda_device) for a in (
            xs, rs.randn(n, B, L).astype(np.float32), rs.randn(n, B, D).astype(np.float32)))
    kp, km, kv = _flat_state(cuda_device, tdv)
    pp, pm, pv = (t.clone() for t in (kp, km, kv))
    kl = _chunk(kp, km, kv, ds.A, n, 0, tdv, noise)
    pl = _chunk(pp, pm, pv, ds.A, n, 0, tdv, noise, plain=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(kp.cpu(), pp.cpu(), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(km.cpu(), pm.cpu(), rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(kv.cpu(), pv.cpu(), rtol=5e-4, atol=1e-7)


@pytest.mark.cuda
def test_kernel_is_chunk_independent(cuda_device):
    """One 40-step launch equals a 15 + 25 split bitwise (resume relies on it)."""
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=cuda_device)
    a = _flat_state(cuda_device, True)
    b = tuple(t.clone() for t in a)
    la = _chunk(*a, ds.A, 40, 0, True)
    lb = torch.cat([_chunk(*b, ds.A, 15, 0, True), _chunk(*b, ds.A, 25, 15, True)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_sampler_words_are_bitwise(cuda_device):
    for seed, step, stream in ((0, 0, 0), (2**64 - 1, 123456, 3), (98765, 7, 1)):
        words, normals = k1.sampler_check(100, 6, step, stream, seed, cuda_device)
        ref = rng.words(seed, step, 100, stream, 6)
        assert torch.equal(words.cpu(), ref)
        np.testing.assert_allclose(normals.cpu(), rng.box_muller(ref), rtol=0, atol=1e-5)
    assert k1.kernel_smem_bytes(B, D, L, ID, ID) == k1.smem_bytes(B, D, L, ID, ID)


# --- K2: sigmoid row 1 (D 7 = 3 + 1 + 3, L 6) --------------------------------
SD, SL, SDD = 7, 6, 3


def _k2_state(device, tdv):
    model = build_vae(data_dim=SD, latent_dim=SL, epsilon=-3.0, tunable_decoder_var=tdv,
                      dataset_name="sigmoid")
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2).to(device)
    return k1.pack_state(state, SD, SL, dual=True)


def _k2_chunk(bufs, a, n, step0, tdv, noise=None, plain=False):
    fn = k1.plain_fused_chunk if plain else k1.run_fused_chunk
    return fn(*bufs, a, n_steps=n, batch=B, data_dim=SD, latent_dim=SL, intrinsic_dim=SDD,
              manifold_dim=SDD, step0=step0, t0=step0, data_seed=rng.derive_seed(69, 1),
              model_seed=rng.derive_seed(0, 3), var_added=0.0, eps_const=-3.0, tdv=tdv,
              lr=1e-4, external_noise=noise, dual=True)


@pytest.mark.cuda
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("tdv", [True, False])
def test_k2_matches_plain(cuda_device, tdv, external):
    ds = SigmoidDataset.create(69, SDD, 3, device=cuda_device)
    n = 32
    noise = None
    if external:
        rs = np.random.RandomState(0)
        z = rs.randn(n, B, SDD).astype(np.float32)
        xs = np.concatenate([z, 1 / (1 + np.exp(-(z @ ds.A.cpu().numpy()))),
                             np.zeros((n, B, 3), np.float32)], axis=-1)
        noise = tuple(torch.as_tensor(a.astype(np.float32), device=cuda_device) for a in (
            xs, rs.randn(n, B, SL), rs.randn(n, B, SD)))
    kb = _k2_state(cuda_device, tdv)
    pb = tuple(t.clone() for t in kb)
    kl = _k2_chunk(kb, ds.A, n, 0, tdv, noise)
    pl = _k2_chunk(pb, ds.A, n, 0, tdv, noise, plain=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(kb[0].cpu(), pb[0].cpu(), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(kb[1].cpu(), pb[1].cpu(), rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(kb[2].cpu(), pb[2].cpu(), rtol=5e-4, atol=1e-7)


@pytest.mark.cuda
def test_k2_is_chunk_independent(cuda_device):
    ds = SigmoidDataset.create(69, SDD, 3, device=cuda_device)
    a = _k2_state(cuda_device, True)
    b = tuple(t.clone() for t in a)
    la = _k2_chunk(a, ds.A, 40, 0, True)
    lb = torch.cat([_k2_chunk(b, ds.A, 15, 0, True), _k2_chunk(b, ds.A, 25, 15, True)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (k1.kernel_smem_bytes(B, SD, SL, SDD, SDD, True)
            == k1.smem_bytes(B, SD, SL, SDD, SDD, True))


# --- K5: sphere row 1 (200|200|200, D = L = 6) --------------------------------
ENC, DEC = (6, 200, 200, 200, 6), (6, 200, 200, 200, 6)


def _k5_state(device, tdv, enc=ENC, dec=DEC):
    model = build_vae(data_dim=enc[0], latent_dim=enc[-1],
                      encoder_layer_sizes="|".join(map(str, enc[1:-1])),
                      decoder_layer_sizes="|".join(map(str, dec[1:-1])),
                      epsilon=-3.0, tunable_decoder_var=tdv)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2).to(device)
    return k5.pack_state(state, enc, dec)


def _k5_chunk(bufs, n, step0, tdv, noise=None, plain=False):
    fn = k5.plain_mlp_fused_chunk if plain else k5.run_mlp_fused_chunk
    return fn(*bufs, None, n_steps=n, batch=B, enc_widths=ENC, dec_widths=DEC, kind="sphere",
              intrinsic_dim=3, manifold_dim=3, step0=step0, t0=step0,
              data_seed=rng.derive_seed(69, 1), model_seed=rng.derive_seed(0, 3),
              var_added=0.0, eps_const=-3.0, tdv=tdv, lr=1e-4, external_noise=noise)


def _assert_k5_close(kl, pl, kb, pb):
    np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(kb[0].cpu(), pb[0].cpu(), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(kb[1].cpu(), pb[1].cpu(), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(kb[2].cpu(), pb[2].cpu(), rtol=1e-3, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("tdv", [True, False])
def test_k5_matches_plain(cuda_device, tdv, external):
    n = 16
    noise = None
    if external:
        rs = np.random.RandomState(0)
        g = rs.randn(n, B, 3).astype(np.float32)
        xs = np.concatenate([g / np.linalg.norm(g, axis=-1, keepdims=True),
                             np.zeros((n, B, 3), np.float32)], axis=-1)
        noise = tuple(torch.as_tensor(a.astype(np.float32), device=cuda_device) for a in (
            xs, rs.randn(n, B, 6), rs.randn(n, B, 6)))
    kb = _k5_state(cuda_device, tdv)
    pb = tuple(t.clone() for t in kb)
    kl = _k5_chunk(kb, n, 0, tdv, noise)
    pl = _k5_chunk(pb, n, 0, tdv, noise, plain=True)
    torch.cuda.synchronize()
    _assert_k5_close(kl, pl, kb, pb)


@pytest.mark.cuda
def test_k5_linear_gaussian_matches_plain(cuda_device):
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=cuda_device)
    enc, dec = (12, 32, 20), (20, 32, 32, 12)
    kb = _k5_state(cuda_device, True, enc, dec)
    pb = tuple(t.clone() for t in kb)
    kw = dict(n_steps=16, batch=B, enc_widths=enc, dec_widths=dec, kind="linear",
              intrinsic_dim=3, manifold_dim=3, step0=5, t0=5, data_seed=7, model_seed=8,
              var_added=0.25, eps_const=-1.0, tdv=True, lr=1e-3)
    kl = k5.run_mlp_fused_chunk(*kb, ds.A, **kw)
    pl = k5.plain_mlp_fused_chunk(*pb, ds.A, **kw)
    torch.cuda.synchronize()
    _assert_k5_close(kl, pl, kb, pb)


@pytest.mark.cuda
def test_k5_is_chunk_independent(cuda_device):
    a = _k5_state(cuda_device, True)
    b = tuple(t.clone() for t in a)
    la = _k5_chunk(a, 40, 0, True)
    lb = torch.cat([_k5_chunk(b, 15, 0, True), _k5_chunk(b, 25, 15, True)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)



# --- K6a: the grid mode of the linear kernel, mixed-dims rows ------------------
LIN_ROWS = [(3, 9, 20), (6, 14, 20), (9, 11, 10), (12, 8, 10)]  # (dd, pd, ld)
SIG_ROWS = [(3, 3, 6), (5, 16, 16), (7, 20, 24)]


def _grid(device, dual, tdv=True):
    """Rows of the linear (K1) or sigmoid (K2) sweep, each with its own
    dataset seed, init and counters: (states, GridRows)."""
    states, rows = [], []
    for i, (dd, pd, ld) in enumerate(SIG_ROWS if dual else LIN_ROWS):
        if dual:
            ds = SigmoidDataset.create(69 + i, dd, pd, device=device)
        else:
            ds = LinearGaussianDataset.create(2 + i, dd, dd, pd, device=device)
        model = build_vae(data_dim=ds.dimension, latent_dim=ld, epsilon=-3.0 if dual else -1.0,
                          tunable_decoder_var=tdv, dataset_name="sigmoid" if dual else None)
        model.init_parameters(i)
        state = TrainState.create(dict(model.named_parameters()),
                                  rng.derive_seed(2 + i, 1), rng.derive_seed(0, 3)).to(device)
        state.step, state.count = 11 * i, 11 * i
        states.append(state)
        rows.append(k1.GridRow(ds.dimension, ld, ds.intrinsic_dim, ds.dim, ds.A, state.step,
                               state.count, state.data_seed, state.model_seed,
                               0.25 if (not dual and i == 1) else 0.0))
    return states, rows


def _grid_kw(dual, tdv=True):
    return dict(batch=B, eps_const=-3.0 if dual else -1.0, tdv=tdv,
                lr=1e-4 if dual else 1e-3, dual=dual)


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [False, True], ids=["K1-rows", "K2-rows"])
def test_k6a_rows_equal_solo_launches_bitwise(cuda_device, dual):
    states, rows = _grid(cuda_device, dual)
    p, m, v = k1.pack_rows(states, rows, dual)
    losses = k1.run_grid_chunk(p, m, v, rows, n_steps=48, **_grid_kw(dual))
    kw = _grid_kw(dual)
    for i, (state, r) in enumerate(zip(states, rows)):
        sp, sm, sv = k1.pack_state(state, r.data_dim, r.latent_dim, dual)
        solo = k1.run_fused_chunk(
            sp, sm, sv, r.a, n_steps=48, batch=B, data_dim=r.data_dim, latent_dim=r.latent_dim,
            intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=r.step0,
            t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed, var_added=r.var_added,
            eps_const=kw["eps_const"], tdv=True, lr=kw["lr"], dual=dual)
        torch.cuda.synchronize()
        assert torch.equal(losses[i], solo), f"row {i} losses"
        for got, want in zip(k1.row_views(p, m, v, rows, dual)[i], (sp, sm, sv)):
            assert torch.equal(got, want), f"row {i} state"


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [False, True], ids=["K1-rows", "K2-rows"])
def test_k6a_matches_plain(cuda_device, dual):
    n = 16
    states, rows = _grid(cuda_device, dual)
    rs = np.random.RandomState(3)
    noise = [tuple(torch.as_tensor(rs.randn(n, B, d).astype(np.float32), device=cuda_device)
                   for d in (r.data_dim, r.latent_dim, r.data_dim)) for r in rows]
    kb = k1.pack_rows(states, rows, dual)
    pb = tuple(t.clone() for t in kb)
    for ext in (noise, None):
        kl = k1.run_grid_chunk(*kb, rows, n_steps=n, external_noise=ext, **_grid_kw(dual))
        pl = k1.plain_grid_chunk(*pb, rows, n_steps=n, external_noise=ext, **_grid_kw(dual))
        torch.cuda.synchronize()
        np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(kb[0].cpu(), pb[0].cpu(), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(kb[1].cpu(), pb[1].cpu(), rtol=5e-4, atol=1e-6)
        np.testing.assert_allclose(kb[2].cpu(), pb[2].cpu(), rtol=5e-4, atol=1e-7)
        rows = [dataclasses.replace(r, step0=r.step0 + n, t0=r.t0 + n) for r in rows]


@pytest.mark.cuda
def test_k6a_is_chunk_independent(cuda_device):
    states, rows = _grid(cuda_device, False)
    a = k1.pack_rows(states, rows)
    b = tuple(t.clone() for t in a)
    la = k1.run_grid_chunk(*a, rows, n_steps=40, **_grid_kw(False))
    lb1 = k1.run_grid_chunk(*b, rows, n_steps=15, **_grid_kw(False))
    later = [dataclasses.replace(r, step0=r.step0 + 15, t0=r.t0 + 15) for r in rows]
    lb2 = k1.run_grid_chunk(*b, later, n_steps=25, **_grid_kw(False))
    torch.cuda.synchronize()
    assert torch.equal(la, torch.cat([lb1, lb2], dim=1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- K5-dual: sigmoid row 1 with 200|200|200 stacks (D 7, L 6) ----------------
DUAL_ENC, DUAL_DEC = (SD, 200, 200, 200, SL), (SL, 200, 200, 200, SD)


def _dual_state(device, tdv):
    model = build_vae(data_dim=SD, latent_dim=SL, encoder_layer_sizes="200|200|200",
                      decoder_layer_sizes="200|200|200", epsilon=-3.0, tunable_decoder_var=tdv,
                      dataset_name="sigmoid")
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2).to(device)
    return k5.pack_state(state, DUAL_ENC, DUAL_DEC, dual=True)


def _dual_chunk(bufs, a, n, step0, tdv, noise=None, plain=False):
    fn = k5.plain_mlp_fused_chunk if plain else k5.run_mlp_fused_chunk
    return fn(*bufs, a, n_steps=n, batch=B, enc_widths=DUAL_ENC, dec_widths=DUAL_DEC,
              kind="sigmoid", intrinsic_dim=SDD, manifold_dim=SDD, step0=step0, t0=step0,
              data_seed=rng.derive_seed(69, 1), model_seed=rng.derive_seed(0, 3),
              var_added=0.0, eps_const=-3.0, tdv=tdv, lr=1e-4, external_noise=noise,
              dual=True)


def _manifold_noise(device, n, rows, seed=0):
    """External (x, z1, z2) per row, x on the row's manifold (the sphere's,
    or [z, σ(z·a), 0] when the row has a column a)."""
    rs = np.random.RandomState(seed)
    out = []
    for D_, L_, dd, a in rows:
        z = rs.randn(n, B, dd).astype(np.float32)
        x = np.zeros((n, B, D_), np.float32)
        if a is None:
            x[:, :, :dd] = z / np.linalg.norm(z, axis=-1, keepdims=True)
        else:
            x[:, :, :dd] = z
            x[:, :, dd] = 1 / (1 + np.exp(-(z @ a.cpu().numpy()[:, 0])))
        out.append(tuple(torch.as_tensor(t.astype(np.float32), device=device) for t in (
            x, rs.randn(n, B, L_), rs.randn(n, B, D_))))
    return out


def _assert_mlp_step_close(kl, pl, rows, plain_rows):
    """One step of the MLP kernel against its plain version from the same
    state: losses at tests/test_mlp_kernel.py's tolerance, each row's p, m
    and v by the 2-norm of the difference relative to the plain version's,
    within that tolerance's rtol (1e-3). At 200|200|200, ReLU
    pre-activations within float32 rounding of zero mask a sample's
    gradient differently in two correct sums, and Adam turns gradients at
    the rounding floor into steps of up to lr: elementwise, two float32
    versions part at some steps, and the partings compound (chip_smoke.py's
    _hold_mlp)."""
    np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=3e-4, atol=3e-4)
    for got, want in zip(rows, plain_rows):
        for x, y in zip(got, want):
            x, y = x.double(), y.double()
            assert float((x - y).norm() / y.norm()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("tdv", [True, False])
def test_k5_dual_matches_plain(cuda_device, tdv, external):
    ds = SigmoidDataset.create(69, SDD, 3, device=cuda_device)
    n = 16
    noise = _manifold_noise(cuda_device, n, [(SD, SL, SDD, ds.A)])[0] if external else None
    kb = _dual_state(cuda_device, tdv)
    for step in range(n):  # one step at a time from the kernel's state
        pb = tuple(t.clone() for t in kb)
        one = None if noise is None else tuple(t[step:step + 1].contiguous() for t in noise)
        kl = _dual_chunk(kb, ds.A, 1, step, tdv, one)
        pl = _dual_chunk(pb, ds.A, 1, step, tdv, one, plain=True)
        torch.cuda.synchronize()
        _assert_mlp_step_close(kl, pl, [kb], [pb])


@pytest.mark.cuda
def test_k5_dual_is_chunk_independent(cuda_device):
    ds = SigmoidDataset.create(69, SDD, 3, device=cuda_device)
    a = _dual_state(cuda_device, True)
    b = tuple(t.clone() for t in a)
    la = _dual_chunk(a, ds.A, 40, 0, True)
    lb = torch.cat([_dual_chunk(b, ds.A, 15, 0, True), _dual_chunk(b, ds.A, 25, 15, True)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- K6b: the grid mode of the MLP kernel, mixed-dims rows ---------------------
SPH_ROWS = [(3, 3, 6), (5, 16, 16), (7, 7, 13)]  # (dd, pd, ld): the sphere sweep's


def _mlp_grid(device, kind, hidden):
    """Rows of the sphere sweep, or sigmoid rows with the dual decoder, each
    with its own dataset seed, init and counters: (states, GridRows)."""
    states, rows = [], []
    spec = "|".join(map(str, hidden))
    for i, (dd, pd, ld) in enumerate(SPH_ROWS if kind == "sphere" else SIG_ROWS):
        if kind == "sphere":
            ds = SphereDataset(dd, pd, device=device)
        else:
            ds = SigmoidDataset.create(69 + i, dd, pd, device=device)
        model = build_vae(data_dim=ds.dimension, latent_dim=ld, encoder_layer_sizes=spec,
                          decoder_layer_sizes=spec, epsilon=-3.0, tunable_decoder_var=True,
                          dataset_name="sigmoid" if kind == "sigmoid" else None)
        model.init_parameters(i)
        state = TrainState.create(dict(model.named_parameters()),
                                  rng.derive_seed(69 + i, 1), rng.derive_seed(0, 3)).to(device)
        state.step, state.count = 11 * i, 11 * i
        states.append(state)
        rows.append(k1.GridRow(ds.dimension, ld, ds.intrinsic_dim, ds.dim,
                               ds.A if kind == "sigmoid" else None, state.step, state.count,
                               state.data_seed, state.model_seed))
    return states, rows


def _mlp_grid_kw(kind, hidden):
    return dict(batch=B, enc_hidden=hidden, dec_hidden=hidden, kind=kind, eps_const=-3.0,
                tdv=True, lr=1e-4, dual=kind == "sigmoid")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sphere", "sigmoid"])
def test_k6b_rows_equal_solo_launches_bitwise(cuda_device, kind):
    hidden = (200, 200, 200)
    states, rows = _mlp_grid(cuda_device, kind, hidden)
    kw = _mlp_grid_kw(kind, hidden)
    dual = kw["dual"]
    p, m, v = k5.pack_rows(states, rows, hidden, hidden, dual)
    losses = k5.run_grid_chunk(p, m, v, rows, n_steps=24, **kw)
    views = k5.row_views(p, m, v, rows, hidden, hidden, dual)
    for i, (state, r) in enumerate(zip(states, rows)):
        enc, dec = k5.row_widths(r, hidden, hidden)
        sp, sm, sv = k5.pack_state(state, enc, dec, dual)
        solo = k5.run_mlp_fused_chunk(
            sp, sm, sv, r.a, n_steps=24, batch=B, enc_widths=enc, dec_widths=dec, kind=kind,
            intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=r.step0,
            t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed, var_added=0.0,
            eps_const=-3.0, tdv=True, lr=1e-4, dual=dual)
        torch.cuda.synchronize()
        assert torch.equal(losses[i], solo), f"row {i} losses"
        for got, want in zip(views[i], (sp, sm, sv)):
            assert torch.equal(got, want), f"row {i} state"


@pytest.mark.cuda
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("kind", ["sphere", "sigmoid"])
def test_k6b_matches_plain(cuda_device, kind, external):
    hidden, n = (200, 200, 200), 8
    states, rows = _mlp_grid(cuda_device, kind, hidden)
    kw = _mlp_grid_kw(kind, hidden)
    dual = kw["dual"]
    noise = _manifold_noise(cuda_device, n, [(r.data_dim, r.latent_dim, r.manifold_dim, r.a)
                                             for r in rows], seed=3)
    kb = k5.pack_rows(states, rows, hidden, hidden, dual)
    for step in range(n):  # one step at a time from the kernel's state
        srows = [dataclasses.replace(r, step0=r.step0 + step, t0=r.t0 + step) for r in rows]
        ext = [tuple(t[step:step + 1].contiguous() for t in nz) for nz in noise] \
            if external else None
        pb = tuple(t.clone() for t in kb)
        kl = k5.run_grid_chunk(*kb, srows, n_steps=1, external_noise=ext, **kw)
        pl = k5.plain_grid_chunk(*pb, srows, n_steps=1, external_noise=ext, **kw)
        torch.cuda.synchronize()
        _assert_mlp_step_close(kl, pl, k5.row_views(*kb, rows, hidden, hidden, dual),
                               k5.row_views(*pb, rows, hidden, hidden, dual))


@pytest.mark.cuda
def test_k6b_is_chunk_independent(cuda_device):
    hidden = (200, 200, 200)
    states, rows = _mlp_grid(cuda_device, "sphere", hidden)
    kw = _mlp_grid_kw("sphere", hidden)
    a = k5.pack_rows(states, rows, hidden, hidden)
    b = tuple(t.clone() for t in a)
    la = k5.run_grid_chunk(*a, rows, n_steps=40, **kw)
    lb1 = k5.run_grid_chunk(*b, rows, n_steps=15, **kw)
    later = [dataclasses.replace(r, step0=r.step0 + 15, t0=r.t0 + 15) for r in rows]
    lb2 = k5.run_grid_chunk(*b, later, n_steps=25, **kw)
    torch.cuda.synchronize()
    assert torch.equal(la, torch.cat([lb1, lb2], dim=1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
