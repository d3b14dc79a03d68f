"""K1, K2, K5, K5-dual, K6a and K6b on the card: the CUDA kernels against
their plain PyTorch versions, and the grid modes' rows against the solo
kernels, each with f32 Adam moments and with bf16 ones (K4,
``--adam_dtype bf16``); every training kernel in its bf16-dot mode
(tensor-core sums) against the bf16 plain version by ρ; and, with a one-rank process group, the ``--mesh
dp=1`` step over NCCL against the no-mesh graph step and
``InvertibleBatchNorm`` with a one-rank NCCL group against none.

These tests need a CUDA device of compute capability 9.0 and nvcc; they
carry the ``cuda`` marker and skip elsewhere. The file imports no JAX, so on
a machine without it run them with the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are those of tests/test_pallas_kernel.py for K1, K2 and K6a and
of tests/test_mlp_kernel.py for K5, K5-dual and K6b: both sides are fp32,
and only summation order and libm ulps differ (the MLP kernel's 200-term
sums through four layers each way compound more of them). bf16 moments
(the weight matrices' slots of the flat buffers) must hold bfloat16 values
on both sides and agree by the drift form of
tests/kernel_test_helpers.py's ulp contract: at least 95% bitwise, the rest
within max(1e-3, 0.02|x|), since a legitimate 1-ulp rounding flip perturbs
the trajectory that later steps follow.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch._scripts.sweep import (  # noqa: E402
    LINEAR_GRID,
    SIGMOID_GRID,
    SPHERE_GRID,
    SWEEP_SEEDS,
)
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
DTYPES = pytest.mark.parametrize("adam_dtype", ["f32", "bf16"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if torch.cuda.get_device_capability() != k1.CAPABILITY:
        pytest.skip("needs an sm_90 device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _keys(x):
    """bfloat16 values → int keys monotonic in float order, 1 apart per ulp."""
    s = x.bfloat16().view(torch.int16).to(torch.int32)
    return torch.where(s < 0, -32768 - s, s)


def _assert_moments(kb, pb, layout, adam_dtype, tol_m, tol_v):
    """Kernel vs plain flat m and v: f32 slots at (rtol, atol); with bf16
    moments each weight matrix's slots bfloat16 values on both sides, at
    least 95% bitwise and the rest within max(1e-3, 0.02|x|)."""
    mask = k1.matrix_mask(layout) if adam_dtype == "bf16" else torch.zeros(0, dtype=torch.bool)
    for got, want, (rtol, atol) in ((kb[1], pb[1], tol_m), (kb[2], pb[2], tol_v)):
        got, want = got.cpu(), want.cpu()
        if adam_dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
            continue
        np.testing.assert_allclose(got[~mask], want[~mask], rtol=rtol, atol=atol)
        _assert_bf16_slots(got, want, layout)


def _assert_bf16_slots(got, want, layout, per_matrix=True):
    """Each weight matrix's moment slots: bfloat16 values on both sides,
    within max(1e-3, 0.02|x|), and at least 95% bitwise, each matrix; or
    (``per_matrix=False``, the MLP kernel one step at a time at full
    width) over all of them together, with at most 0.1% outside the bound:
    the partings _assert_mlp_step_close describes move single elements past
    any elementwise bound, in bf16 as in f32."""
    got, want = got.cpu(), want.cpu()
    mask = k1.matrix_mask(layout)
    x, y = got[mask], want[mask]
    assert torch.equal(x, x.bfloat16().float()) and torch.equal(y, y.bfloat16().float())
    out = (x - y).abs() > (0.02 * y.abs()).clamp_min(1e-3)
    if not per_matrix:
        assert float(out.float().mean()) <= 1e-3
        assert float((_keys(x) == _keys(y)).float().mean()) >= 0.95
        return
    assert not bool(out.any())
    off = 0
    for name, shape in layout:
        n = int(np.prod(shape))
        if len(shape) >= 2:
            x, y = got[off:off + n], want[off:off + n]
            assert float((_keys(x) == _keys(y)).float().mean()) >= 0.95, name
        off += n


def _flat_state(device, tdv, adam_dtype="f32"):
    model = build_vae(data_dim=D, latent_dim=L, epsilon=-1.0, tunable_decoder_var=tdv)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2, adam_dtype).to(device)
    return k1.pack_state(state, D, L)


def _chunk(p, m, v, a, n, step0, tdv, noise=None, plain=False, adam_dtype="f32"):
    fn = k1.plain_fused_chunk if plain else k1.run_fused_chunk
    return fn(p, m, v, a, n_steps=n, batch=B, data_dim=D, latent_dim=L,
              intrinsic_dim=ID, manifold_dim=ID, step0=step0, t0=step0,
              data_seed=rng.derive_seed(2, 1), model_seed=rng.derive_seed(0, 3),
              var_added=0.0, eps_const=-1.0, tdv=tdv, lr=1e-3, external_noise=noise,
              adam_dtype=adam_dtype)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("tdv", [True, False])
def test_kernel_matches_plain(cuda_device, tdv, external, adam_dtype):
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=cuda_device)
    n = 32
    noise = None
    if external:
        rs = np.random.RandomState(0)
        xs = np.zeros((n, B, D), np.float32)
        xs[:, :, :3] = rs.randn(n, B, 3).astype(np.float32) @ ds.A.cpu().numpy().T
        noise = tuple(torch.as_tensor(a, device=cuda_device) for a in (
            xs, rs.randn(n, B, L).astype(np.float32), rs.randn(n, B, D).astype(np.float32)))
    kb = _flat_state(cuda_device, tdv, adam_dtype)
    pb = tuple(t.clone() for t in kb)
    kl = _chunk(*kb, ds.A, n, 0, tdv, noise, adam_dtype=adam_dtype)
    pl = _chunk(*pb, ds.A, n, 0, tdv, noise, plain=True, adam_dtype=adam_dtype)
    torch.cuda.synchronize()
    np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(kb[0].cpu(), pb[0].cpu(), rtol=5e-4, atol=5e-5)
    _assert_moments(kb, pb, k1.param_layout(D, L), adam_dtype, (5e-4, 1e-6), (5e-4, 1e-7))


@pytest.mark.cuda
@DTYPES
def test_kernel_is_chunk_independent(cuda_device, adam_dtype):
    """One 40-step launch equals a 15 + 25 split bitwise (resume relies on it)."""
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=cuda_device)
    a = _flat_state(cuda_device, True, adam_dtype)
    b = tuple(t.clone() for t in a)
    la = _chunk(*a, ds.A, 40, 0, True, adam_dtype=adam_dtype)
    lb = torch.cat([_chunk(*b, ds.A, 15, 0, True, adam_dtype=adam_dtype),
                    _chunk(*b, ds.A, 25, 15, True, adam_dtype=adam_dtype)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_sampler_words_are_bitwise(cuda_device):
    for seed, step, stream in ((0, 0, 0), (2**64 - 1, 123456, 3), (98765, 7, 1)):
        words, normals = k1.sampler_check(100, 6, step, stream, seed, cuda_device)
        ref = rng.words(seed, step, 100, stream, 6)
        assert words.dtype == torch.int32
        assert torch.equal(rng.widen(words.cpu()), ref)
        np.testing.assert_allclose(normals.cpu(), rng.box_muller(ref), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_sampler_normals_equal_the_words_entry(cuda_device):
    """T1's normals-only draw: bitwise the words entry's normals, within
    1e-5 of ops/rng.py, at six (seed, step, stream) triples, at odd shapes
    (calls no multiple of a block; a grid stride no multiple of n_draws)
    and at T1's; each wrapper counts its own launches. The outputs are
    uninitialised, so a (row, draw) the launch skips or misplaces fails."""
    for (seed, step, stream), (rows, n_draws) in zip(
            ((0, 0, 0), (2**64 - 1, 4_000_000_000, 3), (rng.derive_seed(2, 1), 11999, 1),
             (12345, 0, 0), (7, 3, 2), (98765, 1, 1)),
            ((100, 6), (37, 5), (1, 1), (16384, 32), (1000, 3), (300000, 7))):
        before = (k1.sampler_normals.launches, k1.sampler_check.launches)
        only = k1.sampler_normals(rows, n_draws, step, stream, seed, cuda_device)
        words, normals = k1.sampler_check(rows, n_draws, step, stream, seed, cuda_device)
        torch.cuda.synchronize()
        assert (k1.sampler_normals.launches, k1.sampler_check.launches) == (
            before[0] + 1, before[1] + 1)
        ref = rng.words(seed, step, rows, stream, n_draws, device=cuda_device)
        assert torch.equal(rng.widen(words), ref)
        assert torch.equal(only, normals)
        assert float((only - rng.box_muller(ref)).abs().max()) <= 1e-5


# --- K2: sigmoid row 1 (D 7 = 3 + 1 + 3, L 6) --------------------------------
SD, SL, SDD = 7, 6, 3


def _k2_state(device, tdv, adam_dtype="f32"):
    model = build_vae(data_dim=SD, latent_dim=SL, epsilon=-3.0, tunable_decoder_var=tdv,
                      dataset_name="sigmoid")
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2, adam_dtype).to(device)
    return k1.pack_state(state, SD, SL, dual=True)


def _k2_chunk(bufs, a, n, step0, tdv, noise=None, plain=False, adam_dtype="f32"):
    fn = k1.plain_fused_chunk if plain else k1.run_fused_chunk
    return fn(*bufs, a, n_steps=n, batch=B, data_dim=SD, latent_dim=SL, intrinsic_dim=SDD,
              manifold_dim=SDD, step0=step0, t0=step0, data_seed=rng.derive_seed(69, 1),
              model_seed=rng.derive_seed(0, 3), var_added=0.0, eps_const=-3.0, tdv=tdv,
              lr=1e-4, external_noise=noise, dual=True, adam_dtype=adam_dtype)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("tdv", [True, False])
def test_k2_matches_plain(cuda_device, tdv, external, adam_dtype):
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
    kb = _k2_state(cuda_device, tdv, adam_dtype)
    pb = tuple(t.clone() for t in kb)
    kl = _k2_chunk(kb, ds.A, n, 0, tdv, noise, adam_dtype=adam_dtype)
    pl = _k2_chunk(pb, ds.A, n, 0, tdv, noise, plain=True, adam_dtype=adam_dtype)
    torch.cuda.synchronize()
    np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(kb[0].cpu(), pb[0].cpu(), rtol=5e-4, atol=5e-5)
    _assert_moments(kb, pb, k1.param_layout(SD, SL, True), adam_dtype, (5e-4, 1e-6),
                    (5e-4, 1e-7))


@pytest.mark.cuda
@DTYPES
def test_k2_is_chunk_independent(cuda_device, adam_dtype):
    ds = SigmoidDataset.create(69, SDD, 3, device=cuda_device)
    a = _k2_state(cuda_device, True, adam_dtype)
    b = tuple(t.clone() for t in a)
    la = _k2_chunk(a, ds.A, 40, 0, True, adam_dtype=adam_dtype)
    lb = torch.cat([_k2_chunk(b, ds.A, 15, 0, True, adam_dtype=adam_dtype),
                    _k2_chunk(b, ds.A, 25, 15, True, adam_dtype=adam_dtype)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- K5: sphere row 1 (200|200|200, D = L = 6) --------------------------------
ENC, DEC = (6, 200, 200, 200, 6), (6, 200, 200, 200, 6)


def _k5_state(device, tdv, enc=ENC, dec=DEC, adam_dtype="f32"):
    model = build_vae(data_dim=enc[0], latent_dim=enc[-1],
                      encoder_layer_sizes="|".join(map(str, enc[1:-1])),
                      decoder_layer_sizes="|".join(map(str, dec[1:-1])),
                      epsilon=-3.0, tunable_decoder_var=tdv)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2, adam_dtype).to(device)
    return k5.pack_state(state, enc, dec)


def _k5_chunk(bufs, n, step0, tdv, noise=None, plain=False, adam_dtype="f32"):
    fn = k5.plain_mlp_fused_chunk if plain else k5.run_mlp_fused_chunk
    return fn(*bufs, None, n_steps=n, batch=B, enc_widths=ENC, dec_widths=DEC, kind="sphere",
              intrinsic_dim=3, manifold_dim=3, step0=step0, t0=step0,
              data_seed=rng.derive_seed(69, 1), model_seed=rng.derive_seed(0, 3),
              var_added=0.0, eps_const=-3.0, tdv=tdv, lr=1e-4, external_noise=noise,
              adam_dtype=adam_dtype)


def _assert_k5_close(kl, pl, kb, pb, layout, adam_dtype="f32"):
    np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(kb[0].cpu(), pb[0].cpu(), rtol=1e-3, atol=1e-5)
    _assert_moments(kb, pb, layout, adam_dtype, (1e-3, 1e-6), (1e-3, 1e-9))


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("tdv", [True, False])
def test_k5_matches_plain(cuda_device, tdv, external, adam_dtype):
    n = 16
    noise = None
    if external:
        rs = np.random.RandomState(0)
        g = rs.randn(n, B, 3).astype(np.float32)
        xs = np.concatenate([g / np.linalg.norm(g, axis=-1, keepdims=True),
                             np.zeros((n, B, 3), np.float32)], axis=-1)
        noise = tuple(torch.as_tensor(a.astype(np.float32), device=cuda_device) for a in (
            xs, rs.randn(n, B, 6), rs.randn(n, B, 6)))
    kb = _k5_state(cuda_device, tdv, adam_dtype=adam_dtype)
    pb = tuple(t.clone() for t in kb)
    kl = _k5_chunk(kb, n, 0, tdv, noise, adam_dtype=adam_dtype)
    pl = _k5_chunk(pb, n, 0, tdv, noise, plain=True, adam_dtype=adam_dtype)
    torch.cuda.synchronize()
    _assert_k5_close(kl, pl, kb, pb, k5.param_layout(ENC, DEC), adam_dtype)


@pytest.mark.cuda
@DTYPES
def test_k5_linear_gaussian_matches_plain(cuda_device, adam_dtype):
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=cuda_device)
    enc, dec = (12, 32, 20), (20, 32, 32, 12)
    kb = _k5_state(cuda_device, True, enc, dec, adam_dtype)
    pb = tuple(t.clone() for t in kb)
    kw = dict(n_steps=16, batch=B, enc_widths=enc, dec_widths=dec, kind="linear",
              intrinsic_dim=3, manifold_dim=3, step0=5, t0=5, data_seed=7, model_seed=8,
              var_added=0.25, eps_const=-1.0, tdv=True, lr=1e-3, adam_dtype=adam_dtype)
    kl = k5.run_mlp_fused_chunk(*kb, ds.A, **kw)
    pl = k5.plain_mlp_fused_chunk(*pb, ds.A, **kw)
    torch.cuda.synchronize()
    _assert_k5_close(kl, pl, kb, pb, k5.param_layout(enc, dec), adam_dtype)


@pytest.mark.cuda
@DTYPES
def test_k5_is_chunk_independent(cuda_device, adam_dtype):
    a = _k5_state(cuda_device, True, adam_dtype=adam_dtype)
    b = tuple(t.clone() for t in a)
    la = _k5_chunk(a, 40, 0, True, adam_dtype=adam_dtype)
    lb = torch.cat([_k5_chunk(b, 15, 0, True, adam_dtype=adam_dtype),
                    _k5_chunk(b, 25, 15, True, adam_dtype=adam_dtype)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)



# --- K6a: the grid mode of the linear kernel, mixed-dims rows ------------------
LIN_ROWS = [(3, 9, 20), (6, 14, 20), (9, 11, 10), (12, 8, 10)]  # (dd, pd, ld)
SIG_ROWS = [(3, 3, 6), (5, 16, 16), (7, 20, 24)]


def _grid(device, dual, tdv=True, adam_dtype="f32"):
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
        state = TrainState.create(dict(model.named_parameters()), rng.derive_seed(2 + i, 1),
                                  rng.derive_seed(0, 3), adam_dtype).to(device)
        state.step, state.count = 11 * i, 11 * i
        states.append(state)
        rows.append(k1.GridRow(ds.dimension, ld, ds.intrinsic_dim, ds.dim, ds.A, state.step,
                               state.count, state.data_seed, state.model_seed,
                               0.25 if (not dual and i == 1) else 0.0))
    return states, rows


def _grid_kw(dual, tdv=True, adam_dtype="f32"):
    return dict(batch=B, eps_const=-3.0 if dual else -1.0, tdv=tdv,
                lr=1e-4 if dual else 1e-3, dual=dual, adam_dtype=adam_dtype)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("dual", [False, True], ids=["K1-rows", "K2-rows"])
def test_k6a_rows_equal_solo_launches_bitwise(cuda_device, dual, adam_dtype):
    states, rows = _grid(cuda_device, dual, adam_dtype=adam_dtype)
    p, m, v = k1.pack_rows(states, rows, dual)
    kw = _grid_kw(dual, adam_dtype=adam_dtype)
    losses = k1.run_grid_chunk(p, m, v, rows, n_steps=48, **kw)
    for i, (state, r) in enumerate(zip(states, rows)):
        sp, sm, sv = k1.pack_state(state, r.data_dim, r.latent_dim, dual)
        solo = k1.run_fused_chunk(
            sp, sm, sv, r.a, n_steps=48, batch=B, data_dim=r.data_dim, latent_dim=r.latent_dim,
            intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=r.step0,
            t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed, var_added=r.var_added,
            eps_const=kw["eps_const"], tdv=True, lr=kw["lr"], dual=dual, adam_dtype=adam_dtype)
        torch.cuda.synchronize()
        assert torch.equal(losses[i], solo), f"row {i} losses"
        for got, want in zip(k1.row_views(p, m, v, rows, dual)[i], (sp, sm, sv)):
            assert torch.equal(got, want), f"row {i} state"


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("dual", [False, True], ids=["K1-rows", "K2-rows"])
def test_k6a_matches_plain(cuda_device, dual, adam_dtype):
    n = 16
    states, rows = _grid(cuda_device, dual, adam_dtype=adam_dtype)
    layout = [e for r in rows for e in k1.param_layout(r.data_dim, r.latent_dim, dual)]
    rs = np.random.RandomState(3)
    noise = [tuple(torch.as_tensor(rs.randn(n, B, d).astype(np.float32), device=cuda_device)
                   for d in (r.data_dim, r.latent_dim, r.data_dim)) for r in rows]
    kb = k1.pack_rows(states, rows, dual)
    pb = tuple(t.clone() for t in kb)
    kw = _grid_kw(dual, adam_dtype=adam_dtype)
    for ext in (noise, None):
        kl = k1.run_grid_chunk(*kb, rows, n_steps=n, external_noise=ext, **kw)
        pl = k1.plain_grid_chunk(*pb, rows, n_steps=n, external_noise=ext, **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(kb[0].cpu(), pb[0].cpu(), rtol=5e-4, atol=5e-5)
        _assert_moments(kb, pb, layout, adam_dtype, (5e-4, 1e-6), (5e-4, 1e-7))
        rows = [dataclasses.replace(r, step0=r.step0 + n, t0=r.t0 + n) for r in rows]


@pytest.mark.cuda
@DTYPES
def test_k6a_is_chunk_independent(cuda_device, adam_dtype):
    states, rows = _grid(cuda_device, False, adam_dtype=adam_dtype)
    kw = _grid_kw(False, adam_dtype=adam_dtype)
    a = k1.pack_rows(states, rows)
    b = tuple(t.clone() for t in a)
    la = k1.run_grid_chunk(*a, rows, n_steps=40, **kw)
    lb1 = k1.run_grid_chunk(*b, rows, n_steps=15, **kw)
    later = [dataclasses.replace(r, step0=r.step0 + 15, t0=r.t0 + 15) for r in rows]
    lb2 = k1.run_grid_chunk(*b, later, n_steps=25, **kw)
    torch.cuda.synchronize()
    assert torch.equal(la, torch.cat([lb1, lb2], dim=1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- the linear kernel at every shape of the linear and sigmoid sweeps ---------
SWEEP_SHAPES = ([(dd, pd, ld, False) for dd, pd, ld in LINEAR_GRID]
                + [(dd, pd, ld, True) for dd, pd, ld in SIGMOID_GRID])
SWEEP_IDS = [f"{'sigmoid' if dual else 'linear'}-{dd}-{pd}-{ld}" for dd, pd, ld, dual in SWEEP_SHAPES]


def _sweep_row(device, dd, pd, ld, dual, seed, i=0, tdv=True, adam_dtype="f32"):
    """A sweep row's dataset, state (init i, counters 7·i) and GridRow."""
    if dual:
        ds = SigmoidDataset.create(seed, dd, pd, device=device)
    else:
        ds = LinearGaussianDataset.create(seed, dd, dd, pd, device=device)
    model = build_vae(data_dim=ds.dimension, latent_dim=ld, epsilon=-3.0 if dual else -1.0,
                      tunable_decoder_var=tdv, dataset_name="sigmoid" if dual else None)
    model.init_parameters(i)
    state = TrainState.create(dict(model.named_parameters()), rng.derive_seed(seed, 1),
                              rng.derive_seed(i, 3), adam_dtype).to(device)
    state.step = state.count = 7 * i
    row = k1.GridRow(ds.dimension, ld, ds.intrinsic_dim, ds.dim, ds.A, state.step, state.count,
                     state.data_seed, state.model_seed)
    return ds, state, row


def _sweep_noise(row, n, rs, dual, device):
    """External (x, z1, z2) of n steps with x on the row's manifold."""
    z = rs.randn(n, B, row.intrinsic_dim).astype(np.float32)
    a = row.a.cpu().numpy()
    if dual:
        x = np.concatenate([z, 1 / (1 + np.exp(-(z @ a))),
                            np.zeros((n, B, row.data_dim - row.manifold_dim - 1), np.float32)], -1)
    else:
        x = np.zeros((n, B, row.data_dim), np.float32)
        x[:, :, :row.manifold_dim] = z @ a.T
    return tuple(torch.as_tensor(t.astype(np.float32), device=device) for t in (
        x, rs.randn(n, B, row.latent_dim), rs.randn(n, B, row.data_dim)))


@pytest.mark.cuda
@pytest.mark.parametrize("tdv", [True, False])
@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=SWEEP_IDS)
def test_linear_kernel_matches_plain_at_every_sweep_shape(cuda_device, shape, tdv):
    """K1 / K2 against the plain version over 64 steps at every sweep row's
    shape, with external noise and with the in-kernel sampler, at K1's
    tolerances."""
    dd, pd, ld, dual = shape
    ds, state, row = _sweep_row(cuda_device, dd, pd, ld, dual, 69 if dual else 2, tdv=tdv)
    n = 64
    ext = _sweep_noise(row, n, np.random.RandomState(8), dual, cuda_device)
    for noise in (ext, None):
        kb = k1.pack_state(state, ds.dimension, ld, dual)
        pb = tuple(t.clone() for t in kb)
        kw = dict(n_steps=n, batch=B, data_dim=ds.dimension, latent_dim=ld,
                  intrinsic_dim=ds.intrinsic_dim, manifold_dim=ds.dim, step0=0, t0=0,
                  data_seed=row.data_seed, model_seed=row.model_seed, var_added=0.0,
                  eps_const=-3.0 if dual else -1.0, tdv=tdv, lr=1e-4 if dual else 1e-3,
                  external_noise=noise, dual=dual)
        kl = k1.run_fused_chunk(*kb, ds.A, **kw)
        pl = k1.plain_fused_chunk(*pb, ds.A, **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(kb[0].cpu(), pb[0].cpu(), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(kb[1].cpu(), pb[1].cpu(), rtol=5e-4, atol=1e-6)
        np.testing.assert_allclose(kb[2].cpu(), pb[2].cpu(), rtol=5e-4, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_dots", [False, True], ids=["fp32-dots", "bf16-dots"])
@pytest.mark.parametrize("which", ["linear", "sigmoid"])
def test_k6a_sweep_rows_equal_solo_launches_bitwise(cuda_device, which, bf16_dots):
    """Every row of the whole sweep (21 linear, 18 sigmoid: each shape with
    each of the sweep's seeds) in one K6a launch equals its solo launch
    bitwise, over 64 steps of the in-kernel sampler, in both dot modes."""
    dual = which == "sigmoid"
    grid = SIGMOID_GRID if dual else LINEAR_GRID
    made = [_sweep_row(cuda_device, dd, pd, ld, dual, seed, i)
            for i, ((dd, pd, ld), seed) in enumerate(
                (shape, seed) for shape in grid for seed in SWEEP_SEEDS[which])]
    states, rows = [m[1] for m in made], [m[2] for m in made]
    assert len(rows) == (18 if dual else 21)
    kw = dict(batch=B, eps_const=-3.0 if dual else -1.0, tdv=True, lr=1e-4 if dual else 1e-3,
              dual=dual, bf16_dots=bf16_dots)
    p, m, v = k1.pack_rows(states, rows, dual)
    losses = k1.run_grid_chunk(p, m, v, rows, n_steps=64, **kw)
    views = k1.row_views(p, m, v, rows, dual)
    for i, (state, r) in enumerate(zip(states, rows)):
        sp, sm, sv = k1.pack_state(state, r.data_dim, r.latent_dim, dual)
        solo = k1.run_fused_chunk(
            sp, sm, sv, r.a, n_steps=64, batch=B, data_dim=r.data_dim, latent_dim=r.latent_dim,
            intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=r.step0,
            t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed, var_added=0.0,
            eps_const=kw["eps_const"], tdv=True, lr=kw["lr"], dual=dual, bf16_dots=bf16_dots)
        torch.cuda.synchronize()
        assert torch.equal(losses[i], solo), f"row {i} losses"
        for got, want in zip(views[i], (sp, sm, sv)):
            assert torch.equal(got, want), f"row {i} state"


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_dots", [False, True], ids=["fp32-dots", "bf16-dots"])
@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=SWEEP_IDS)
def test_library_smem_equals_planner_at_every_sweep_shape(cuda_device, shape, bf16_dots):
    dd, pd, ld, dual = shape
    D = dd + pd + (1 if dual else 0)
    assert (k1.kernel_smem_bytes(B, D, ld, dd, dd, dual, bf16_dots)
            == k1.smem_bytes(B, D, ld, dd, dd, dual, bf16_dots) <= k1.SMEM_LIMIT)


# --- bf16 dots: the linear kernel's tensor-core products ----------------------
# (dd, pd, ld, dual) of K1 at linear row 1, K2 at sigmoid row 1, the sigmoid
# sweep's largest row, and a wide K1 row (D 35, L 33: three k16 steps in
# every product, the last one mostly padding)
LINEAR_BF16 = {"K1": (3, 9, 20, False), "K2": (3, 3, 6, True), "K2-largest": (7, 20, 24, True),
               "K1-wide": (3, 32, 33, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("external", [True, False], ids=["external", "sampler"])
@pytest.mark.parametrize("kernel", sorted(LINEAR_BF16))
def test_linear_bf16_dots_match_plain_by_rho(cuda_device, kernel, external):
    """K1 and K2 in the bf16-dot mode, 8 steps one at a time from the bf16
    plain version's state, in both dot modes: ρ = ‖kernel − plain_bf16‖ /
    ‖plain_fp32 − plain_bf16‖ over the steps' losses, parameters, m and v
    at most 0.1 for the bf16-dot kernel and at least 0.5 for the fp32 one,
    the control (chip_smoke.py phase 53's contract); then 40 = 15 + 25
    bitwise in the bf16-dot mode."""
    dd, pd, ld, dual = LINEAR_BF16[kernel]
    ds, state, row = _sweep_row(cuda_device, dd, pd, ld, dual, 69 if dual else 2)
    n = 8
    ext = _sweep_noise(row, n, np.random.RandomState(18), dual, cuda_device) if external else None
    kw = dict(batch=B, data_dim=ds.dimension, latent_dim=ld, intrinsic_dim=ds.intrinsic_dim,
              manifold_dim=ds.dim, data_seed=row.data_seed, model_seed=row.model_seed,
              var_added=0.0, eps_const=-3.0 if dual else -1.0, tdv=True,
              lr=1e-4 if dual else 1e-3, dual=dual)
    start = k1.pack_state(state, ds.dimension, ld, dual)
    sq = {}  # (dots, key) → [Σ‖kernel − plain_bf16‖², Σ‖plain_fp32 − plain_bf16‖²]
    cur = start
    for step in range(n):
        noise = None if ext is None else tuple(t[step:step + 1].contiguous() for t in ext)
        got, plain = {}, {}
        for dots in (True, False):
            kb, pb = tuple(t.clone() for t in cur), tuple(t.clone() for t in cur)
            kl = k1.run_fused_chunk(*kb, ds.A, n_steps=1, step0=step, t0=step,
                                    external_noise=noise, bf16_dots=dots, **kw)
            pl = k1.plain_fused_chunk(*pb, ds.A, n_steps=1, step0=step, t0=step,
                                      external_noise=noise, bf16_dots=dots, **kw)
            got[dots], plain[dots] = (kl, *kb), (pl, *pb)
        torch.cuda.synchronize()
        for dots in (True, False):
            for key, x, b, f in zip(("losses", "p", "m", "v"), got[dots], plain[True],
                                    plain[False]):
                acc = sq.setdefault((dots, key), [0.0, 0.0])
                acc[0] += float((x.double() - b.double()).norm() ** 2)
                acc[1] += float((f.double() - b.double()).norm() ** 2)
        assert bool(torch.isfinite(got[True][0]).all())
        cur = plain[True][1:]
    rho = {k: (num / max(den, 1e-300)) ** 0.5 for k, (num, den) in sq.items()}
    for key in ("losses", "p", "m", "v"):
        assert rho[(True, key)] <= 0.1, (key, rho)
        assert rho[(False, key)] >= 0.5, (key, rho)
    a = tuple(t.clone() for t in start)
    b = tuple(t.clone() for t in start)
    la = k1.run_fused_chunk(*a, ds.A, n_steps=40, step0=0, t0=0, bf16_dots=True, **kw)
    lb = torch.cat([k1.run_fused_chunk(*b, ds.A, n_steps=15, step0=0, t0=0, bf16_dots=True, **kw),
                    k1.run_fused_chunk(*b, ds.A, n_steps=25, step0=15, t0=15, bf16_dots=True,
                                       **kw)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- K5-dual: sigmoid row 1 with 200|200|200 stacks (D 7, L 6) ----------------
DUAL_ENC, DUAL_DEC = (SD, 200, 200, 200, SL), (SL, 200, 200, 200, SD)


def _dual_state(device, tdv, adam_dtype="f32"):
    model = build_vae(data_dim=SD, latent_dim=SL, encoder_layer_sizes="200|200|200",
                      decoder_layer_sizes="200|200|200", epsilon=-3.0, tunable_decoder_var=tdv,
                      dataset_name="sigmoid")
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2, adam_dtype).to(device)
    return k5.pack_state(state, DUAL_ENC, DUAL_DEC, dual=True)


def _dual_chunk(bufs, a, n, step0, tdv, noise=None, plain=False, adam_dtype="f32"):
    fn = k5.plain_mlp_fused_chunk if plain else k5.run_mlp_fused_chunk
    return fn(*bufs, a, n_steps=n, batch=B, enc_widths=DUAL_ENC, dec_widths=DUAL_DEC,
              kind="sigmoid", intrinsic_dim=SDD, manifold_dim=SDD, step0=step0, t0=step0,
              data_seed=rng.derive_seed(69, 1), model_seed=rng.derive_seed(0, 3),
              var_added=0.0, eps_const=-3.0, tdv=tdv, lr=1e-4, external_noise=noise,
              dual=True, adam_dtype=adam_dtype)


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


def _assert_mlp_step_close(kl, pl, rows, plain_rows, layouts=None):
    """One step of the MLP kernel against its plain version from the same
    state: losses at tests/test_mlp_kernel.py's tolerance, each row's p, m
    and v by the 2-norm of the difference relative to the plain version's,
    within that tolerance's rtol (1e-3). At 200|200|200, ReLU
    pre-activations within float32 rounding of zero mask a sample's
    gradient differently in two correct sums, and Adam turns gradients at
    the rounding floor into steps of up to lr: elementwise, two float32
    versions part at some steps, and the partings compound (chip_smoke.py's
    _hold_mlp). With bf16 moments (``layouts``, one a row) the weight
    matrices' m and v are held by _assert_bf16_slots too, the bitwise share
    over all of a row's matrices: the same gradient noise flips one bf16
    rounding in ~5% of a small first layer's elements at some steps
    (1 ulp = 2⁻⁸ relative; the parted f32 sums differ by ~1e-4)."""
    np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=3e-4, atol=3e-4)
    for i, (got, want) in enumerate(zip(rows, plain_rows)):
        for x, y in zip(got, want):
            x, y = x.double(), y.double()
            assert float((x - y).norm() / y.norm()) <= 1e-3
        if layouts is not None:
            for x, y in zip(got[1:], want[1:]):
                _assert_bf16_slots(x, y, layouts[i], per_matrix=False)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("tdv", [True, False])
def test_k5_dual_matches_plain(cuda_device, tdv, external, adam_dtype):
    ds = SigmoidDataset.create(69, SDD, 3, device=cuda_device)
    n = 16
    noise = _manifold_noise(cuda_device, n, [(SD, SL, SDD, ds.A)])[0] if external else None
    kb = _dual_state(cuda_device, tdv, adam_dtype)
    layouts = [k5.param_layout(DUAL_ENC, DUAL_DEC, True)] if adam_dtype == "bf16" else None
    for step in range(n):  # one step at a time from the kernel's state
        pb = tuple(t.clone() for t in kb)
        one = None if noise is None else tuple(t[step:step + 1].contiguous() for t in noise)
        kl = _dual_chunk(kb, ds.A, 1, step, tdv, one, adam_dtype=adam_dtype)
        pl = _dual_chunk(pb, ds.A, 1, step, tdv, one, plain=True, adam_dtype=adam_dtype)
        torch.cuda.synchronize()
        _assert_mlp_step_close(kl, pl, [kb], [pb], layouts)


@pytest.mark.cuda
@DTYPES
def test_k5_dual_is_chunk_independent(cuda_device, adam_dtype):
    ds = SigmoidDataset.create(69, SDD, 3, device=cuda_device)
    a = _dual_state(cuda_device, True, adam_dtype)
    b = tuple(t.clone() for t in a)
    la = _dual_chunk(a, ds.A, 40, 0, True, adam_dtype=adam_dtype)
    lb = torch.cat([_dual_chunk(b, ds.A, 15, 0, True, adam_dtype=adam_dtype),
                    _dual_chunk(b, ds.A, 25, 15, True, adam_dtype=adam_dtype)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- K6b: the grid mode of the MLP kernel, mixed-dims rows ---------------------
SPH_ROWS = [(3, 3, 6), (5, 16, 16), (7, 7, 13)]  # (dd, pd, ld): the sphere sweep's


def _mlp_grid(device, kind, hidden, adam_dtype="f32"):
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
        state = TrainState.create(dict(model.named_parameters()), rng.derive_seed(69 + i, 1),
                                  rng.derive_seed(0, 3), adam_dtype).to(device)
        state.step, state.count = 11 * i, 11 * i
        states.append(state)
        rows.append(k1.GridRow(ds.dimension, ld, ds.intrinsic_dim, ds.dim,
                               ds.A if kind == "sigmoid" else None, state.step, state.count,
                               state.data_seed, state.model_seed))
    return states, rows


def _mlp_grid_kw(kind, hidden, adam_dtype="f32"):
    return dict(batch=B, enc_hidden=hidden, dec_hidden=hidden, kind=kind, eps_const=-3.0,
                tdv=True, lr=1e-4, dual=kind == "sigmoid", adam_dtype=adam_dtype)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("kind", ["sphere", "sigmoid"])
def test_k6b_rows_equal_solo_launches_bitwise(cuda_device, kind, adam_dtype):
    hidden = (200, 200, 200)
    states, rows = _mlp_grid(cuda_device, kind, hidden, adam_dtype)
    kw = _mlp_grid_kw(kind, hidden, adam_dtype)
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
            eps_const=-3.0, tdv=True, lr=1e-4, dual=dual, adam_dtype=adam_dtype)
        torch.cuda.synchronize()
        assert torch.equal(losses[i], solo), f"row {i} losses"
        for got, want in zip(views[i], (sp, sm, sv)):
            assert torch.equal(got, want), f"row {i} state"


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("kind", ["sphere", "sigmoid"])
def test_k6b_matches_plain(cuda_device, kind, external, adam_dtype):
    hidden, n = (200, 200, 200), 8
    states, rows = _mlp_grid(cuda_device, kind, hidden, adam_dtype)
    kw = _mlp_grid_kw(kind, hidden, adam_dtype)
    dual = kw["dual"]
    layouts = [k5.param_layout(*k5.row_widths(r, hidden, hidden), dual) for r in rows] \
        if adam_dtype == "bf16" else None
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
                               k5.row_views(*pb, rows, hidden, hidden, dual), layouts)


@pytest.mark.cuda
@DTYPES
def test_k6b_is_chunk_independent(cuda_device, adam_dtype):
    hidden = (200, 200, 200)
    states, rows = _mlp_grid(cuda_device, "sphere", hidden, adam_dtype)
    kw = _mlp_grid_kw("sphere", hidden, adam_dtype)
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


# --- the cluster design: ragged widths, rows past one wave, the launch ---------

@pytest.mark.cuda
@DTYPES
def test_mlp_ragged_widths_match_plain(cuda_device, adam_dtype):
    """Widths that fill no tile: 7|13|200 stacks at D 21, L 16 (the sphere
    sweep's widest row), one step at a time from the kernel's state."""
    ds = SphereDataset(5, 16, device=cuda_device)
    enc, dec = (21, 7, 13, 200, 16), (16, 7, 13, 200, 21)
    kb = _k5_state(cuda_device, True, enc, dec, adam_dtype)
    layouts = [k5.param_layout(enc, dec)] if adam_dtype == "bf16" else None
    noise = _manifold_noise(cuda_device, 8, [(21, 16, 5, None)], seed=4)[0]
    for step in range(8):
        pb = tuple(t.clone() for t in kb)
        kw = dict(n_steps=1, batch=B, enc_widths=enc, dec_widths=dec, kind="sphere",
                  intrinsic_dim=ds.intrinsic_dim, manifold_dim=ds.dim, step0=step, t0=step,
                  data_seed=7, model_seed=8, var_added=0.0, eps_const=-3.0, tdv=True, lr=1e-3,
                  adam_dtype=adam_dtype,
                  external_noise=tuple(t[step:step + 1].contiguous() for t in noise)
                  if step % 2 else None)
        kl = k5.run_mlp_fused_chunk(*kb, None, **kw)
        pl = k5.plain_mlp_fused_chunk(*pb, None, **kw)
        torch.cuda.synchronize()
        _assert_mlp_step_close(kl, pl, [kb], [pb], layouts)


def _sphere_rows(device, n_rows):
    """``n_rows`` rows of the sphere sweep's dims, each with its own seeds."""
    states, rows = [], []
    for i in range(n_rows):
        dd, pd, ld = SPHERE_GRID[i % len(SPHERE_GRID)]
        ds = SphereDataset(dd, pd, device=device)
        model = build_vae(data_dim=ds.dimension, latent_dim=ld, encoder_layer_sizes="200|200|200",
                          decoder_layer_sizes="200|200|200", epsilon=-3.0,
                          tunable_decoder_var=True)
        model.init_parameters(i)
        state = TrainState.create(dict(model.named_parameters()), rng.derive_seed(69 + i, 1),
                                  rng.derive_seed(i, 3)).to(device)
        states.append(state)
        rows.append(k1.GridRow(ds.dimension, ld, ds.intrinsic_dim, ds.dim, None, 0, 0,
                               state.data_seed, state.model_seed))
    return states, rows


@pytest.mark.cuda
def test_k6b_rows_past_one_wave_equal_solo_launches_bitwise(cuda_device):
    """20 sphere rows: more rows than clusters of 8 the card holds at once,
    so some clusters train two rows in turn; each row is its solo launch."""
    hidden = (200, 200, 200)
    states, rows = _sphere_rows(cuda_device, 20)
    kw = _mlp_grid_kw("sphere", hidden)
    p, m, v = k5.pack_rows(states, rows, hidden, hidden)
    losses = k5.run_grid_chunk(p, m, v, rows, n_steps=6, **kw)
    torch.cuda.synchronize()
    plan = k5.last_launch()
    assert plan["clusters"] < 20, plan  # a second turn on some clusters
    views = k5.row_views(p, m, v, rows, hidden, hidden)
    for i, (state, r) in enumerate(zip(states, rows)):
        enc, dec = k5.row_widths(r, hidden, hidden)
        sp, sm, sv = k5.pack_state(state, enc, dec)
        solo = k5.run_mlp_fused_chunk(
            sp, sm, sv, None, n_steps=6, batch=B, enc_widths=enc, dec_widths=dec, kind="sphere",
            intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=0, t0=0,
            data_seed=r.data_seed, model_seed=r.model_seed, var_added=0.0, eps_const=-3.0,
            tdv=True, lr=1e-4)
        torch.cuda.synchronize()
        assert torch.equal(losses[i], solo), f"row {i} losses"
        for got, want in zip(views[i], (sp, sm, sv)):
            assert torch.equal(got, want), f"row {i} state"


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1, 3, 15])
def test_mlp_kernel_is_a_cluster_launch(cuda_device, n_rows):
    """The launch is one cluster a row (no cooperative launch: the kernel
    traps without its cluster), of CLUSTER_WIDE CTAs where that trains the
    rows in no more turns than CLUSTER, with the shared memory the planner
    gives the rows on that cluster size."""
    hidden = (200, 200, 200)
    states, rows = _sphere_rows(cuda_device, n_rows)
    p, m, v = k5.pack_rows(states, rows, hidden, hidden)
    k5.run_grid_chunk(p, m, v, rows, n_steps=1, **_mlp_grid_kw("sphere", hidden))
    torch.cuda.synchronize()
    smem = {size: max(k5.smem_bytes(B, *k5.row_widths(r, hidden, hidden), cluster=size)
                      for r in rows) for size in (k5.CLUSTER, k5.CLUSTER_WIDE)}
    most = {size: k5.grid(n_rows, smem, size)["max_clusters"] for size in smem}
    plan = k5.grid(n_rows, smem)
    size = k5.cluster_size(n_rows, most)
    assert plan["cluster_size"] == size
    assert k5.last_launch() == {"clusters": plan["clusters"], "cluster_size": size,
                                "smem": smem[size]}
    assert plan["clusters"] == min(n_rows, plan["max_clusters"]) and plan["max_clusters"] >= 1
    for r in rows:
        enc, dec = k5.row_widths(r, hidden, hidden)
        for cluster in smem:
            assert (k5.library_smem_bytes(B, enc, dec, cluster=cluster)
                    == k5.smem_bytes(B, enc, dec, cluster=cluster))


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("widths", ["sphere", "ragged"])
def test_mlp_cluster_size_changes_no_result(cuda_device, adam_dtype, widths):
    """12 steps on clusters of 8 and of 16 CTAs train bitwise the same: no
    output's sum is split, so the cut of the products changes nothing."""
    enc, dec = (ENC, DEC) if widths == "sphere" else ((21, 7, 13, 200, 16), (16, 7, 13, 200, 21))
    start = _k5_state(cuda_device, True, enc, dec, adam_dtype)
    row = k1.GridRow(enc[0], enc[-1], 3, 3, None, 0, 0, rng.derive_seed(69, 1),
                     rng.derive_seed(0, 3))
    got = {}
    for cluster in (k5.CLUSTER, k5.CLUSTER_WIDE):
        state = tuple(t.clone() for t in start)
        losses = torch.empty(1, 12, device=cuda_device)
        k5._launch([state], losses, [row], n_steps=12, batch=B, enc_hidden=enc[1:-1],
                   dec_hidden=dec[1:-1], kind="sphere", eps_const=-3.0, tdv=True, lr=1e-4,
                   dual=False, external_noise=None, adam_dtype=adam_dtype, cluster=cluster)
        assert k5.last_launch()["cluster_size"] == cluster
        got[cluster] = (losses, *state)
    torch.cuda.synchronize()
    for a, b in zip(got[k5.CLUSTER], got[k5.CLUSTER_WIDE]):
        assert torch.equal(a, b)


# --- bf16 dots: the MLP kernel's tensor-core sums -------------------------------
# (21, 7, 13, 200, 16) and the dual (7, 7, 13, 200, 6): contractions of 7, 13,
# 16, 21 and 100 (no multiple of 16), narrow units on both sides of a stack;
# and three 8-layer stacks whose [a_in, 1]ᵀ·G products hold the bias row at
# every row of a unit (tests/test_torch_mlp_tc.py:BIAS_ROW_STACKS)
BF16_STACKS = {"narrow": ((21, 7, 13, 200, 16), (16, 7, 13, 200, 21), 5, False),
               "narrow-dual": ((7, 7, 13, 200, 6), (6, 7, 13, 200, 7), 3, True),
               "bias-rows-0": ((32, 33, 34, 35, 36, 37, 38, 39, 30),
                               (30, 40, 41, 42, 43, 44, 45, 46, 32), 3, False),
               "bias-rows-1": ((47, 48, 49, 50, 51, 52, 53, 54, 31),
                               (31, 55, 56, 57, 58, 59, 60, 61, 47), 3, False),
               "bias-rows-2": ((8, 1, 2, 3, 4, 5, 6, 7, 9), (9, 10, 11, 12, 13, 14, 15, 16, 8),
                               3, False)}


def _rho(got, plain_bf16, plain_fp32):
    g, b, f = (t.double().flatten() for t in (got, plain_bf16, plain_fp32))
    return float((g - b).norm() / (f - b).norm().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(BF16_STACKS))
def test_k5_bf16_dots_match_plain_by_rho(cuda_device, widths):
    """K5 (and K5-dual) in the bf16-dot mode at BF16_STACKS, 8 steps
    one at a time from the bf16 plain version's state, in both dot modes:
    ρ = ‖kernel − plain_bf16‖ / ‖plain_fp32 − plain_bf16‖ over the steps'
    losses, m and v at most 0.1 for the bf16-dot kernel and at least 0.5 for
    the fp32 one, the control (chip_smoke.py phase 54's contract: the
    kernel's f32 sums run in another order than the plain version's, and a
    one-ulp difference can round an activation to the next bfloat16); then
    12 steps on clusters of 8 and of 16 bitwise the same."""
    enc, dec, dd, dual = BF16_STACKS[widths]
    a = SigmoidDataset.create(69, dd, 3, device=cuda_device).A if dual else None
    model = build_vae(data_dim=enc[0], latent_dim=enc[-1],
                      encoder_layer_sizes="|".join(map(str, enc[1:-1])),
                      decoder_layer_sizes="|".join(map(str, dec[1:-1])), epsilon=-3.0,
                      tunable_decoder_var=True, dataset_name="sigmoid" if dual else None)
    model.init_parameters(0)
    start = k5.pack_state(TrainState.create(dict(model.named_parameters()), 1, 2).to(
        cuda_device), enc, dec, dual)
    kw = dict(batch=B, enc_widths=enc, dec_widths=dec, kind="sigmoid" if dual else "sphere",
              intrinsic_dim=dd, manifold_dim=dd, data_seed=7, model_seed=8, var_added=0.0,
              eps_const=-3.0, tdv=True, lr=1e-3, dual=dual)
    sq = {}  # (dots, losses|m|v) → [Σ‖kernel − plain_bf16‖², Σ‖plain_fp32 − plain_bf16‖²]
    state = start
    for step in range(8):
        got, plain = {}, {}
        for dots in (True, False):
            kb, pb = tuple(t.clone() for t in state), tuple(t.clone() for t in state)
            kl = k5.run_mlp_fused_chunk(*kb, a, n_steps=1, step0=step, t0=step, bf16_dots=dots,
                                        **kw)
            pl = k5.plain_mlp_fused_chunk(*pb, a, n_steps=1, step0=step, t0=step,
                                          bf16_dots=dots, **kw)
            got[dots], plain[dots] = (kl, kb[1], kb[2]), (pl, pb[1], pb[2])
            if dots:
                nxt = pb
        torch.cuda.synchronize()
        for dots in (True, False):
            for key, x, b, f in zip(("losses", "m", "v"), got[dots], plain[True], plain[False]):
                acc = sq.setdefault((dots, key), [0.0, 0.0])
                acc[0] += float((x.double() - b.double()).norm() ** 2)
                acc[1] += float((f.double() - b.double()).norm() ** 2)
        state = nxt
    rho = {k: (num / max(den, 1e-300)) ** 0.5 for k, (num, den) in sq.items()}
    for key in ("losses", "m", "v"):
        assert rho[(True, key)] <= 0.1, (key, rho)
        assert rho[(False, key)] >= 0.5, (key, rho)
    row = k1.GridRow(enc[0], enc[-1], dd, dd, a, 0, 0, 7, 8)
    outs = {}
    for cluster in (k5.CLUSTER, k5.CLUSTER_WIDE):
        bufs = tuple(t.clone() for t in start)
        losses = torch.empty(1, 12, device=cuda_device)
        k5._launch([bufs], losses, [row], n_steps=12, batch=B, enc_hidden=enc[1:-1],
                   dec_hidden=dec[1:-1], kind=kw["kind"], eps_const=-3.0, tdv=True, lr=1e-3,
                   dual=dual, external_noise=None, adam_dtype="f32", bf16_dots=True,
                   cluster=cluster)
        assert k5.last_launch()["cluster_size"] == cluster
        outs[cluster] = (losses, *bufs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[k5.CLUSTER][0]).all())
    for x, y in zip(outs[k5.CLUSTER], outs[k5.CLUSTER_WIDE]):
        assert torch.equal(x, y)


# --- K4: a bf16 launch is the f32 launch, its matrix moments rounded ------------

@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K5", "K5-dual", "K6a", "K6b"])
def test_bf16_launch_is_the_f32_launch_rounded(cuda_device, kernel):
    """One step from the same state: the bf16 launch's weight-matrix
    moments are the f32 launch's rounded to nearest even, bit for bit, and
    its other moments, its vector parameters and its losses are the f32
    launch's (the gradients and the f32 update are the same code; K4 only
    rounds). Independent of how far the kernel and the plain version part."""
    dev = cuda_device
    if kernel == "K1":
        bufs, layout = _flat_state(dev, True, "bf16"), k1.param_layout(D, L)
        a = LinearGaussianDataset.create(2, 3, 3, 9, device=dev).A

        def launch(b, step, adam):
            return _chunk(*b, a, 1 if step else 3, step, True, adam_dtype=adam)
    elif kernel == "K2":
        bufs, layout = _k2_state(dev, True, "bf16"), k1.param_layout(SD, SL, True)
        a = SigmoidDataset.create(69, SDD, 3, device=dev).A

        def launch(b, step, adam):
            return _k2_chunk(b, a, 1 if step else 3, step, True, adam_dtype=adam)
    elif kernel == "K5":
        bufs, layout = _k5_state(dev, True, adam_dtype="bf16"), k5.param_layout(ENC, DEC)

        def launch(b, step, adam):
            return _k5_chunk(b, 1 if step else 3, step, True, adam_dtype=adam)
    elif kernel == "K5-dual":
        bufs = _dual_state(dev, True, "bf16")
        layout = k5.param_layout(DUAL_ENC, DUAL_DEC, True)
        a = SigmoidDataset.create(69, SDD, 3, device=dev).A

        def launch(b, step, adam):
            return _dual_chunk(b, a, 1 if step else 3, step, True, adam_dtype=adam)
    else:
        dual = kernel == "K6a"  # the sigmoid sweep's rows on K6a; sphere rows on K6b
        hidden = (200, 200, 200)
        if kernel == "K6a":
            states, rows = _grid(dev, dual, adam_dtype="bf16")
            bufs = k1.pack_rows(states, rows, dual)
            layout = [e for r in rows for e in k1.param_layout(r.data_dim, r.latent_dim, dual)]
        else:
            states, rows = _mlp_grid(dev, "sphere", hidden, "bf16")
            bufs = k5.pack_rows(states, rows, hidden, hidden)
            layout = [e for r in rows
                      for e in k5.param_layout(*k5.row_widths(r, hidden, hidden))]

        def launch(b, step, adam):
            later = [dataclasses.replace(r, step0=r.step0 + step, t0=r.t0 + step) for r in rows]
            if kernel == "K6a":
                return k1.run_grid_chunk(*b, later, n_steps=1 if step else 3,
                                         **_grid_kw(dual, adam_dtype=adam))
            return k5.run_grid_chunk(*b, later, n_steps=1 if step else 3,
                                     **_mlp_grid_kw("sphere", hidden, adam))
    launch(bufs, 0, "bf16")  # three bf16 steps: moments of bf16 values, not zero
    f32, bf16 = tuple(t.clone() for t in bufs), tuple(t.clone() for t in bufs)
    lf, lb = launch(f32, 3, "f32"), launch(bf16, 3, "bf16")
    torch.cuda.synchronize()
    mask = k1.matrix_mask(layout).to(dev)
    assert bool(mask.any()) and torch.equal(lf, lb)
    assert torch.equal(bf16[0][~mask], f32[0][~mask])
    for got, ref in zip(bf16[1:], f32[1:]):
        assert torch.equal(got[mask], ref[mask].bfloat16().float())
        assert torch.equal(got[~mask], ref[~mask])
        assert not torch.equal(got[mask], ref[mask])  # the f32 launch did not round


# --- the probes T1–T5 (csrc/probes.cu; the training kernels' sampler) -------
# chip_smoke.py phases 26–30's tolerances: T4's identity dots are one
# rounding each (bitwise expected, held at rtol 1e-6); T3's sums, and T4's
# on random inputs, run in another order (rtol 1e-4, atol 1e-5); T5's h at
# the MLP kernel's tolerance, Adam's change at rtol 1e-3 of its own size;
# T2's products are exact, its sums in another order (rtol 1e-5, atol 1e-4).
PROBE_H_TOL = (1e-3, 1e-5)  # the MLP kernel's params tolerance


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["phase", "cluster"])
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t4_chain_forms_match_plain(cuda_device, n_chains, form):
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools.probe_mlp_interleave import inputs

    xs, ws = inputs(n_chains, cuda_device)
    kw = dict(n_steps=3, depth=probes.T4_DEPTH, weights_per_depth=False, epilogue="clamp")
    before = (probes.chain_chunk.launches, probes.chain_chunk.cluster_launches)
    got = probes.chain_chunk(xs, ws, form=form, **kw)
    want = probes.plain_chain_chunk(xs, ws, **kw)
    torch.cuda.synchronize()
    after = (probes.chain_chunk.launches, probes.chain_chunk.cluster_launches)
    assert after[form == "cluster"] == before[form == "cluster"] + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["phase", "cluster"])
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t4_random_chain_forms_match_plain(cuda_device, n_chains, form):
    """Random xs and ws (check_inputs), 8 dots: a transposed or permuted
    weight slice, a misplaced exchange or a dropped term fails here."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools.probe_mlp_interleave import check_inputs

    xs, ws = check_inputs(n_chains, cuda_device)
    kw = dict(n_steps=1, depth=8, weights_per_depth=False, epilogue="clamp")
    got = probes.chain_chunk(xs, ws, form=form, **kw)
    want = probes.plain_chain_chunk(xs, ws, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t4_cluster_launches_repeat_bitwise(cuda_device, n_chains):
    """Fixed sums in K order, no atomics: two launches of the cluster form
    give the same bits, on the tool's inputs and on random ones."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools.probe_mlp_interleave import check_inputs, inputs

    for make, n_steps, depth in ((inputs, 3, probes.T4_DEPTH), (check_inputs, 1, 8)):
        xs, ws = make(n_chains, cuda_device)
        a = probes._chain_cluster_launch(xs, ws, n_steps, depth)
        b = probes._chain_cluster_launch(xs, ws, n_steps, depth)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["T4", "T3"])
def test_phase_fp32_chain_0_of_4_is_chain_0_alone(cuda_device, probe):
    """The fp32 phase form sums each output's 8 K slices in rank order at
    any chain count: chain 0 of 4 chains equals chain 0 alone bitwise
    (random inputs; T4 8 dots, T3 2 trips), and two launches give the same
    bits."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_mlp_interleave as t4
    from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3

    if probe == "T4":
        xs, ws = t4.check_inputs(4, cuda_device)
        kw = dict(n_steps=1, depth=8, weights_per_depth=False, epilogue="clamp")
    else:
        xs, ws = t3.inputs(4, cuda_device)
        kw = dict(n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm")
    four = probes.chain_chunk(xs, ws, form="phase", **kw)
    again = probes.chain_chunk(xs, ws, form="phase", **kw)
    one = probes.chain_chunk(xs[:1].contiguous(), ws[:1].contiguous(), form="phase", **kw)
    torch.cuda.synchronize()
    assert torch.equal(four, again)
    assert torch.equal(four[0], one[0])


@pytest.mark.cuda
def test_t4_cluster_split_variants_are_uncounted(cuda_device):
    """The time split's variants stop each dot early and count nothing;
    only chain_chunk's cluster form counts."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools.probe_mlp_interleave import inputs

    xs, ws = inputs(2, cuda_device)
    before = probes.chain_chunk.cluster_launches
    for upto in ("stage", "products", "store"):
        probes._chain_cluster_launch(xs, ws, 2, probes.T4_DEPTH, upto=upto)
    torch.cuda.synchronize()
    assert probes.chain_chunk.cluster_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t3_chains_match_plain(cuda_device, n_chains):
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools.probe_mxu_pipelining import inputs

    xs, ws = inputs(n_chains, cuda_device)
    kw = dict(n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm")
    got = probes.chain_chunk(xs, ws, **kw)
    want = probes.plain_chain_chunk(xs, ws, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("interleave", [False, True], ids=["tail", "interleaved"])
def test_t5_adam_overlap_matches_plain(cuda_device, interleave):
    """h at the MLP kernel's tolerance; what Adam changed in w, m and v at
    rtol 1e-3, atol 1e-3 of the plain version's largest change, on inputs
    where Adam's arithmetic shows. Controls: the state left as it was (Adam
    dropped) and the other variant's plain result fail that comparison."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_adam_overlap as t5

    kb = t5.check_inputs(cuda_device)
    pb, start, other = (tuple(t.clone() for t in kb) for _ in range(3))
    before = probes.adam_overlap_chunk.launches
    h = probes.adam_overlap_chunk(*kb, n_steps=3, interleave=interleave)
    ph = probes.plain_adam_overlap_chunk(*pb, n_steps=3, interleave=interleave)
    probes.plain_adam_overlap_chunk(*other, n_steps=3, interleave=not interleave)
    torch.cuda.synchronize()
    assert probes.adam_overlap_chunk.launches == before + 1
    np.testing.assert_allclose(h.cpu().numpy(), ph.cpu().numpy(), *PROBE_H_TOL)
    for name, got, ref, s0, o in zip("wmv", kb[1:], pb[1:], start[1:], other[1:]):
        assert t5.delta_mismatch(got, ref, s0) <= t5.DELTA_RTOL, name
        assert t5.delta_mismatch(s0, ref, s0) > 100 * t5.DELTA_RTOL, name
        assert t5.delta_mismatch(o, ref, s0) > 10 * t5.DELTA_RTOL, name


# T3's and T5's stream form (chain_stream_kernel): at T3's and T5's
# tolerances above, two launches bitwise equal, outputs written whole into
# reused (uninitialised) memory, and a launch the library refuses raises.
def _poison_allocator(shape, device, copies=4):
    """Leave NaN-filled blocks of ``shape`` in the caching allocator, so the
    next allocations of that size start as NaN, not zeros."""
    blocks = [torch.full(shape, float("nan"), device=device) for _ in range(copies)]
    del blocks


@pytest.mark.cuda
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t3_stream_matches_plain(cuda_device, n_chains):
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools.probe_mxu_pipelining import inputs

    xs, ws = inputs(n_chains, cuda_device)
    kw = dict(n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm")
    before = probes.chain_chunk.stream_launches
    _poison_allocator(xs.shape, cuda_device)
    got = probes.chain_chunk(xs, ws, form="stream", **kw)
    want = probes.plain_chain_chunk(xs, ws, **kw)
    torch.cuda.synchronize()
    assert probes.chain_chunk.stream_launches == before + 1
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs_of", ["inputs", "check_inputs"])
@pytest.mark.parametrize("interleave", [False, True], ids=["tail", "interleaved"])
def test_t5_stream_matches_plain(cuda_device, interleave, inputs_of):
    """T5's stream form on the tool's inputs and on check_inputs, 3 steps:
    h at the MLP kernel's tolerance, what Adam changed within DELTA_RTOL;
    the controls (state left as it was; on check_inputs the other mode's
    plain result) fail the comparison."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_adam_overlap as t5

    kb = getattr(t5, inputs_of)(cuda_device)
    pb, start, other = (tuple(t.clone() for t in kb) for _ in range(3))
    before = probes.adam_overlap_chunk.stream_launches
    _poison_allocator((1, *kb[0].shape), cuda_device)
    h = probes.adam_overlap_chunk(*kb, n_steps=3, interleave=interleave, form="stream")
    ph = probes.plain_adam_overlap_chunk(*pb, n_steps=3, interleave=interleave)
    probes.plain_adam_overlap_chunk(*other, n_steps=3, interleave=not interleave)
    torch.cuda.synchronize()
    assert probes.adam_overlap_chunk.stream_launches == before + 1
    assert bool(torch.isfinite(h).all())
    np.testing.assert_allclose(h.cpu().numpy(), ph.cpu().numpy(), *PROBE_H_TOL)
    for name, got, ref, s0, o in zip("wmv", kb[1:], pb[1:], start[1:], other[1:]):
        assert t5.delta_mismatch(got, ref, s0) <= t5.DELTA_RTOL, name
        assert t5.delta_mismatch(s0, ref, s0) > 100 * t5.DELTA_RTOL, name
        if inputs_of == "check_inputs":
            assert t5.delta_mismatch(o, ref, s0) > 10 * t5.DELTA_RTOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["t3", "tail", "interleaved"])
def test_stream_launches_repeat_bitwise(cuda_device, mode):
    """Fixed sums (K order; the column sums in row-group order), no
    atomics: two launches from the same state give the same bits."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_adam_overlap as t5
    from vae_training_tpu_torch.tools.probe_mxu_pipelining import inputs

    for n_chains in ([1, 2, 4] if mode == "t3" else [1]):
        if mode == "t3":
            xs, ws = inputs(n_chains, cuda_device)
            a, b = (probes._stream_launch("t3", xs, ws, None, None, 2) for _ in range(2))
            torch.cuda.synchronize()
            assert torch.equal(a, b)
            continue
        runs = []
        for _ in range(2):
            x, ws, ms, vs = t5.check_inputs(cuda_device)
            h = probes._stream_launch(mode, x[None], ws, ms, vs, 3)
            runs.append((h, ws, ms, vs))
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(*runs))


@pytest.mark.cuda
def test_stream_refused_plans_raise(cuda_device):
    """The library refuses 5 chains and T5 on more than one chain or without
    its moments; the wrapper raises, and nothing runs in its place."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_adam_overlap as t5
    from vae_training_tpu_torch.tools.probe_mxu_pipelining import inputs

    xs, ws = inputs(4, cuda_device)
    x, w, m, v = t5.inputs(cuda_device)
    x5, w5 = torch.cat([xs, xs[:1]]), torch.cat([ws, ws[:1]])
    with pytest.raises(RuntimeError, match="probes_chain_stream \\(t3\\) launch failed"):
        probes._stream_launch("t3", x5, w5, None, None, 1)
    with pytest.raises(RuntimeError, match="probes_chain_stream \\(tail\\) launch failed"):
        probes._stream_launch("tail", xs[:2], w, m, v, 1)
    with pytest.raises(RuntimeError, match="probes_chain_stream \\(interleaved\\) launch"):
        probes._stream_launch("interleaved", x[None], w, None, None, 1)


@pytest.mark.cuda
def test_stream_split_variants_are_uncounted(cuda_device):
    """The time split's variants stop each dot early and count nothing."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_adam_overlap as t5
    from vae_training_tpu_torch.tools.probe_mxu_pipelining import inputs

    xs, ws = inputs(2, cuda_device)
    x, w5, m5, v5 = t5.inputs(cuda_device)
    before = (probes.chain_chunk.stream_launches, probes.adam_overlap_chunk.stream_launches)
    for upto in ("weights", "products", "exchange"):
        probes._stream_launch("t3", xs, ws, None, None, 2, upto=upto)
        probes._stream_launch("tail", x[None], w5, m5, v5, 2, upto=upto)
    torch.cuda.synchronize()
    assert (probes.chain_chunk.stream_launches,
            probes.adam_overlap_chunk.stream_launches) == before


# T3, T4 and T5 in bf16 dots (every product a tensor-core mma.sync of
# bf16-rounded operands, f32 sums), against the plain bf16 versions. A chain
# of dense dots parts between any two f32 summation orders (a last-bit
# difference flips a rounding to bf16, which moves every output of the
# next dot: ρ ~0.1 after 8 dots between torch's order and float64 sums,
# tests/test_torch_probes_bf16.py), so dense inputs are held one dot deep,
# ρ = ‖kernel − plain_bf16‖ / ‖plain_fp32 − plain_bf16‖ ≤ 1e-3, with the
# fp32 instantiation's ρ ≥ 0.5; the tools' whole trips and steps run on
# two_term_inputs (two products an output, in distinct k16 steps: one f32
# rounding in any order) and must equal the plain version bitwise, as must
# T4 on the tool's inputs (the identity rounds to 1.0 in bf16). T5 on
# check_inputs (diagonal weights) 2 steps: h at ρ ≤ 0.1, Adam's change
# within DELTA_RTOL. Two launches give the same bits.
def _rho(got, ref, other):
    got, ref, other = (t.detach().double().cpu() for t in (got, ref, other))
    return float((got - ref).norm() / (other - ref).norm())


_BF16_COUNTER = {"phase": "bf16_launches", "cluster": "bf16_cluster_launches",
                 "stream": "bf16_stream_launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("probe_form", ["T4-phase", "T4-cluster", "T3-phase", "T3-stream"])
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_chain_bf16_forms_one_dot_deep_match_plain_by_rho(cuda_device, probe_form, n_chains):
    """Dense random inputs (T4's check_inputs, T3's inputs with its first
    weight), one dot: ρ ≤ 1e-3; the fp32 instantiation ρ ≥ 0.5; each
    launch counted by its mode's counter. A stream launch runs whole trips
    of 8: its trip is 7 identities and then the dense weight
    (dense_trip_inputs), one dense dot in bf16 dots."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_mlp_interleave as t4
    from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3

    probe, form = probe_form.split("-")
    if probe == "T4":
        xs, ws = t4.check_inputs(n_chains, cuda_device)
        kw = dict(n_steps=1, depth=1, weights_per_depth=False, epilogue="clamp")
    elif form == "stream":
        xs, ws = t3.dense_trip_inputs(n_chains, cuda_device)
        kw = dict(n_steps=1, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm")
    else:
        xs, ws = t3.inputs(n_chains, cuda_device)
        ws = ws[:, :probes.W].contiguous()
        kw = dict(n_steps=1, depth=1, weights_per_depth=True, epilogue="renorm")
    counter = _BF16_COUNTER[form]
    fp32_counter = counter.replace("bf16_", "")
    before = (getattr(probes.chain_chunk, counter), getattr(probes.chain_chunk, fp32_counter))
    got = probes.chain_chunk(xs, ws, form=form, bf16_dots=True, **kw)
    ctrl = probes.chain_chunk(xs, ws, form=form, **kw)
    want = probes.plain_chain_chunk(xs, ws, bf16_dots=True, **kw)
    f32 = probes.plain_chain_chunk(xs, ws, **kw)
    torch.cuda.synchronize()
    assert (getattr(probes.chain_chunk, counter),
            getattr(probes.chain_chunk, fp32_counter)) == (before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(got).all())
    assert _rho(got, want, f32) <= 1e-3
    assert _rho(ctrl, want, f32) >= 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("probe_form", ["T4-phase", "T4-cluster", "T3-phase", "T3-stream"])
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_chain_bf16_forms_on_two_term_inputs_are_bitwise(cuda_device, probe_form, n_chains):
    """The tools' whole steps (T4: 2 of 24 dots) and trips (T3: 2 of 8) on
    two_term_inputs: the kernel equals the plain bf16 version bitwise, and
    the fp32 instantiation does not."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_mlp_interleave as t4
    from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3

    probe, form = probe_form.split("-")
    mod, kw = ((t4, dict(n_steps=2, depth=probes.T4_DEPTH, weights_per_depth=False,
                         epilogue="clamp")) if probe == "T4"
               else (t3, dict(n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True,
                              epilogue="renorm")))
    xs, ws = mod.two_term_inputs(n_chains, cuda_device)
    before = getattr(probes.chain_chunk, _BF16_COUNTER[form])
    _poison_allocator(xs.shape, cuda_device)
    got = probes.chain_chunk(xs, ws, form=form, bf16_dots=True, **kw)
    ctrl = probes.chain_chunk(xs, ws, form=form, **kw)
    want = probes.plain_chain_chunk(xs, ws, bf16_dots=True, **kw)
    torch.cuda.synchronize()
    assert getattr(probes.chain_chunk, _BF16_COUNTER[form]) == before + 1
    assert torch.equal(got, want)
    assert not torch.equal(ctrl, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["phase", "cluster"])
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t4_bf16_forms_on_the_tool_inputs_are_bitwise(cuda_device, n_chains, form):
    """eye·(1 + 1e-4c) rounds to the identity in bf16, so every output is one
    exact product: the kernel equals the plain version and bf16(0.01(c + 1))
    bitwise, which the fp32 chain does not."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.ops.precision import bf16_round
    from vae_training_tpu_torch.tools.probe_mlp_interleave import inputs

    xs, ws = inputs(n_chains, cuda_device)
    kw = dict(n_steps=3, depth=probes.T4_DEPTH, weights_per_depth=False, epilogue="clamp")
    got = probes.chain_chunk(xs, ws, form=form, bf16_dots=True, **kw)
    want = probes.plain_chain_chunk(xs, ws, bf16_dots=True, **kw)
    f32 = probes.plain_chain_chunk(xs, ws, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, bf16_round(xs))
    assert not torch.equal(f32, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["phase", "stream"])
@pytest.mark.parametrize("interleave", [False, True], ids=["tail", "interleaved"])
def test_t5_bf16_forms_match_plain(cuda_device, interleave, form):
    """T5 in bf16 dots on check_inputs, 2 steps: h by ρ ≤ 0.1 against the
    plain bf16 version (the fp32 kernel's ρ ≥ 0.5); what Adam changed in
    w, m and v within DELTA_RTOL; the state left as it was fails that. (A
    third step's rounding flips move Δv past DELTA_RTOL between the JAX
    tool and the plain version on the CPU, both right:
    tests/test_torch_probes_bf16.py.)"""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_adam_overlap as t5

    kb = t5.check_inputs(cuda_device)
    pb, fb, cb, start = (tuple(t.clone() for t in kb) for _ in range(4))
    counter = "bf16_launches" if form == "phase" else "bf16_stream_launches"
    before = getattr(probes.adam_overlap_chunk, counter)
    kw = dict(n_steps=2, interleave=interleave)
    h = probes.adam_overlap_chunk(*kb, form=form, bf16_dots=True, **kw)
    ctrl = probes.adam_overlap_chunk(*cb, form=form, **kw)
    ph = probes.plain_adam_overlap_chunk(*pb, bf16_dots=True, **kw)
    fh = probes.plain_adam_overlap_chunk(*fb, **kw)
    torch.cuda.synchronize()
    assert getattr(probes.adam_overlap_chunk, counter) == before + 1
    assert bool(torch.isfinite(h).all())
    assert _rho(h, ph, fh) <= 0.1 and _rho(ctrl, ph, fh) >= 0.5
    for name, got, ref, s0 in zip("wmv", kb[1:], pb[1:], start[1:]):
        assert t5.delta_mismatch(got, ref, s0) <= t5.DELTA_RTOL, name
        assert t5.delta_mismatch(s0, ref, s0) > 100 * t5.DELTA_RTOL, name


@pytest.mark.cuda
def test_probe_bf16_launches_repeat_bitwise(cuda_device):
    """Fixed sums in every bf16 form, no atomics: two launches, one bits;
    the time split's variants launch in bf16 too and count nothing."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_adam_overlap as t5
    from vae_training_tpu_torch.tools import probe_mlp_interleave as t4
    from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3

    for n_chains in (1, 2, 4):
        xs, ws = t4.check_inputs(n_chains, cuda_device)
        kw = dict(n_steps=1, depth=8, weights_per_depth=False, epilogue="clamp", bf16_dots=True)
        for form in probes.T4_FORMS:
            a, b = (probes.chain_chunk(xs, ws, form=form, **kw) for _ in range(2))
            torch.cuda.synchronize()
            assert torch.equal(a, b), (n_chains, form)
        xs, ws = t3.inputs(n_chains, cuda_device)
        kw = dict(n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm",
                  bf16_dots=True)
        for form in probes.T3_FORMS:
            a, b = (probes.chain_chunk(xs, ws, form=form, **kw) for _ in range(2))
            torch.cuda.synchronize()
            assert torch.equal(a, b), (n_chains, form)
    for form in probes.T5_FORMS:
        for interleave in (False, True):
            runs = []
            for _ in range(2):
                x, ws, ms, vs = t5.check_inputs(cuda_device)
                h = probes.adam_overlap_chunk(x, ws, ms, vs, n_steps=3, interleave=interleave,
                                              form=form, bf16_dots=True)
                runs.append((h, ws, ms, vs))
            torch.cuda.synchronize()
            assert all(torch.equal(p, q) for p, q in zip(*runs)), (form, interleave)
    counts = [getattr(f, n) for f in (probes.chain_chunk, probes.adam_overlap_chunk)
              for n in dir(f) if n.endswith("launches")]
    xs, ws = t4.inputs(2, cuda_device)
    for upto in ("stage", "products", "store"):
        probes._chain_cluster_launch(xs, ws, 2, probes.T4_DEPTH, upto=upto, bf16_dots=True)
    xs, ws = t3.inputs(2, cuda_device)
    x, w5, m5, v5 = t5.inputs(cuda_device)
    for upto in ("weights", "compute", "products", "exchange"):
        probes._stream_launch("t3", xs, ws, None, None, 2, upto=upto, bf16_dots=True)
        probes._stream_launch("tail", x[None], w5, m5, v5, 2, upto=upto, bf16_dots=True)
    torch.cuda.synchronize()
    assert counts == [getattr(f, n) for f in (probes.chain_chunk, probes.adam_overlap_chunk)
                      for n in dir(f) if n.endswith("launches")]


# T2's shapes: the contract's smallest, zero-padded rows and columns, uneven
# K slices (272 = 17 units of 16), the tool's, and several rounds a CTA
DOT_SHAPES = [(16, 16, 8), (48, 32, 24), (112, 272, 40), (128, 256, 256), (256, 512, 512)]


def _dot_inputs(shape, device):
    M, K, N = shape
    rs = np.random.RandomState(M + K + N)
    return (torch.as_tensor(rs.randn(M, K).astype(np.float32), device=device),
            torch.as_tensor(rs.randn(K, N).astype(np.float32), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DOT_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", ["fp32", "tf32", "bf16"])
def test_dot_modes_match_plain(cuda_device, mode, shape):
    """The kernel against its plain version (the products are exact, the
    sums in another order): a wrong wgmma descriptor, layout or slice gives
    wrong numbers without a fault, so odd shapes too."""
    from vae_training_tpu_torch.kernels import probes

    x, w = _dot_inputs(shape, cuda_device)
    before = probes.dot_modes.launches
    got = probes.dot_modes(x, w, mode)
    want = probes.plain_dot_modes(x, w, mode)
    torch.cuda.synchronize()
    assert probes.dot_modes.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "tf32", "bf16"])
def test_dot_modes_are_bitwise_repeatable(cuda_device, mode):
    """Split-K sums in cluster-rank order, no atomics: two calls, one bits."""
    from vae_training_tpu_torch.kernels import probes

    for shape in DOT_SHAPES:
        x, w = _dot_inputs(shape, cuda_device)
        a, b = probes.dot_modes(x, w, mode), probes.dot_modes(x, w, mode)
        torch.cuda.synchronize()
        assert torch.equal(a, b), shape


@pytest.mark.cuda
def test_dot_tf32_rounds_ties_away(cuda_device):
    """Operands whose low 13 bits sit exactly at a TF32 rounding tie, one
    nonzero term an output (x has one nonzero a row), so every sum is exact:
    the kernel must equal round_tf32(x) · round_tf32(w) bitwise, which a
    tensor core fed the raw fp32 values (truncation) does not."""
    from vae_training_tpu_torch.kernels import probes

    M, K, N = 128, 256, 256
    rs = np.random.RandomState(5)

    def ties(shape):
        mant = rs.randint(0, 1 << 10, size=shape).astype(np.uint32) << 13
        expo = rs.randint(120, 134, size=shape).astype(np.uint32) << 23
        sign = rs.randint(0, 2, size=shape).astype(np.uint32) << 31
        return (sign | expo | mant | np.uint32(0x1000)).view(np.float32)

    x = ties((M, K))
    keep = np.zeros((M, K), np.float32)
    keep[np.arange(M), rs.randint(0, K, M)] = 1.0
    x = torch.as_tensor(x * keep, device=cuda_device)
    w = torch.as_tensor(ties((K, N)), device=cuda_device)
    got = probes.dot_modes(x, w, "tf32")
    want = (probes.round_tf32(x).double() @ probes.round_tf32(w).double()).float()
    trunc = ((x.view(torch.int32) & ~0x1FFF).view(torch.float32).double()
             @ (w.view(torch.int32) & ~0x1FFF).view(torch.float32).double()).float()
    torch.cuda.synchronize()
    assert not torch.equal(want, trunc)  # the test can tell the two apart
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "tf32", "bf16"])
def test_dot_library_plan_equals_dot_plan(cuda_device, mode):
    from vae_training_tpu_torch.kernels import probes

    for shape in DOT_SHAPES + [(128, 2048, 256), (64 * 200, 16, 8)]:
        assert probes.library_dot_plan(*shape, mode) == probes.dot_plan(*shape, mode), shape


@pytest.mark.cuda
def test_dot_launch_variants_are_uncounted(cuda_device):
    """The time split's variants (launch only, staging, products) launch
    the kernel without counting it; only dot_modes counts."""
    from vae_training_tpu_torch.kernels import probes

    x, w = _dot_inputs((128, 256, 256), cuda_device)
    before = probes.dot_modes.launches
    for upto in ("launch", "stage", "products"):
        probes._dot_launch(x, w, "bf16", upto)
    torch.cuda.synchronize()
    assert probes.dot_modes.launches == before


@pytest.mark.cuda
def test_dot_mode_errors_are_ordered(cuda_device):
    from vae_training_tpu_torch.tools.check_precision import check

    err = check(cuda_device)["err"]
    assert err["fp32"] < err["bf16"] / 100 and err["fp32"] < err["tf32"] < err["bf16"]


@pytest.mark.cuda
def test_t1_battery_passes_on_the_kernel_sampler(cuda_device):
    from vae_training_tpu_torch.tools import check_kernel_rng as t1

    assert t1.battery(t1.card_draw(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", ["8|16", "32|64"])
def test_epoch_graph_equals_op_by_op_bitwise(cuda_device, channels):
    """The conv VAE's epoch chunk as one CUDA graph replay a step against
    its op-by-op form, two epochs from the same state: losses, parameters
    and moments bitwise (cuDNN deterministic, TF32 off: ``use_fp32_math``)."""
    from vae_training_tpu_torch.config import use_fp32_math
    from vae_training_tpu_torch.data import ImageDataset
    from vae_training_tpu_torch.models.conv import build_conv_vae
    from vae_training_tpu_torch.train import step as torch_step

    use_fp32_math(cuda_device)
    ds = ImageDataset.synthetic_digits(0, n=256, size=28, device=cuda_device)
    model = build_conv_vae(image_hwc=ds.shape, latent_dim=16, channels_spec=channels,
                           epsilon=-1.0, tunable_decoder_var=True)
    model.init_parameters(0)
    model.to(cuda_device)
    got = {}
    for graph in (False, True):
        chunk = torch_step.EpochChunk(model, ds, batch_size=32, lr=1e-3, graph=graph)
        state = TrainState.create(dict(model.named_parameters()), 5, 6)
        losses = []
        for epoch in range(2):
            state, lo = chunk(state, epoch)
            losses.append(lo)
        got[graph] = (state, torch.cat(losses))
    (se, le), (sg, lg) = got[False], got[True]
    assert le.shape == (16,) and bool(torch.isfinite(le).all())
    assert torch.equal(le, lg)
    assert (se.step, se.count) == (sg.step, sg.count) == (16, 16)
    for tree in ("params", "m", "v"):
        for k, t in getattr(se, tree).items():
            assert torch.equal(t, getattr(sg, tree)[k]), f"{tree}[{k}]"


@pytest.fixture
def one_rank_group(cuda_device, tmp_path):
    """A one-rank process group (gloo for host objects), as chip_smoke.py
    phases 49 and 52 start it; the paths under test make their NCCL
    groups on the card."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    yield cuda_device
    dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_world_size_one_dp_step_equals_the_graph_step(one_rank_group):
    """``--mesh dp=1`` with a one-rank NCCL group: the dp step as one CUDA
    graph replay, its all-reduce captured, equals the no-mesh graph step
    bitwise (20 steps at sphere row 1's shapes, 200|200|200)."""
    from vae_training_tpu_torch.config import use_fp32_math
    from vae_training_tpu_torch.parallel import data_parallel, make_mesh
    from vae_training_tpu_torch.train import step as torch_step

    dev = one_rank_group
    use_fp32_math(dev)
    ds = SphereDataset(3, 3, device=dev)
    model = build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes="200|200|200",
                      decoder_layer_sizes="200|200|200", epsilon=-3.0,
                      tunable_decoder_var=True, dataset_name="sphere")
    model.init_parameters(0)
    model.to(dev)
    dp = data_parallel(make_mesh("dp=1"), B, 0, dev)
    assert dp.groups[0][0] is not None  # a real one-rank NCCL group
    got = []
    for par in (None, dp):
        state = TrainState.create(dict(model.named_parameters()),
                                  rng.derive_seed(69, rng.SEED_TRAIN_DATA),
                                  rng.derive_seed(0, rng.SEED_TRAIN_Z))
        chunk = torch_step.GraphChunk(model, ds, batch_size=B, lr=1e-4, dp=par)
        got.append(chunk(state, 20))
    (sa, la), (sb, lb) = got
    assert torch.equal(la, lb) and bool(torch.isfinite(la).all())
    for tree in ("params", "m", "v"):
        for k, t in getattr(sa, tree).items():
            assert torch.equal(t, getattr(sb, tree)[k]), f"{tree}[{k}]"


@pytest.mark.cuda
def test_batch_norm_with_a_one_rank_nccl_group(one_rank_group):
    """``InvertibleBatchNorm`` with a one-rank NCCL group equals it without
    a group: outputs, running stats and gradients bitwise."""
    from vae_training_tpu_torch.ops.flows import InvertibleBatchNorm
    from vae_training_tpu_torch.utils.process import device_group

    dev = one_rank_group
    group = device_group([0], dev)
    x = torch.randn(64, 6, generator=torch.Generator().manual_seed(0)).to(dev) * 3 + 2
    got = []
    for g in (None, group):
        bn = InvertibleBatchNorm(6, process_group=g).to(dev)
        xi = x.clone().requires_grad_(True)
        y = bn(xi)
        (y * y).sum().backward()
        got.append((y.detach(), xi.grad, bn.scale.grad, dict(bn.named_buffers())))
    (ya, ga, sa, ba), (yb, gb, sb, bb) = got
    assert torch.equal(ya, yb) and torch.equal(ga, gb) and torch.equal(sa, sb)
    for k in ba:
        assert torch.equal(ba[k], bb[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["T4", "T3"])
def test_phase_bf16_sums_do_not_depend_on_the_chain_count(cuda_device, probe):
    """The phase form's bf16 units sum in an order fixed by the unit, not by
    the chains sharing the launch: chain 0 of 4 equals chain 0 alone
    bitwise, one dense dot deep and over whole steps or trips."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_mlp_interleave as t4
    from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3

    if probe == "T4":
        xs, ws = t4.check_inputs(4, cuda_device)
        kws = [dict(n_steps=1, depth=d, weights_per_depth=False, epilogue="clamp") for d in (1, 8)]
    else:
        xs, ws = t3.inputs(4, cuda_device)
        kws = [dict(n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm")]
    for kw in kws:
        four = probes.chain_chunk(xs, ws, form="phase", bf16_dots=True, **kw)
        one = probes.chain_chunk(xs[:1], ws[:1], form="phase", bf16_dots=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(four[0], one[0]), kw


@pytest.mark.cuda
def test_phase_split_variants_are_uncounted(cuda_device):
    """The phase form's time-split variants (the barriers alone, the work
    alone) launch in both dot modes and count nothing; the whole variant
    equals chain_chunk's launch bitwise."""
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.tools import probe_adam_overlap as t5
    from vae_training_tpu_torch.tools import probe_mlp_interleave as t4

    xs, ws = t4.check_inputs(2, cuda_device)
    x, w5, m5, v5 = t5.inputs(cuda_device)

    def counts():
        return [getattr(f, n) for f in (probes.chain_chunk, probes.adam_overlap_chunk)
                for n in dir(f) if n.endswith("launches")]

    before = counts()
    for bf16 in (False, True):
        for upto in ("barriers", "work", "all"):
            probes._phase_launch(xs, ws, 1, 8, False, "clamp", upto=upto, bf16_dots=bf16)
            probes._phase_launch(x[None], w5, 1, probes.N_BUF * probes.DOTS_PER_BUF, False,
                                 "clamp", 1, m5, v5, upto=upto, bf16_dots=bf16)
    torch.cuda.synchronize()
    assert counts() == before
    for bf16 in (False, True):
        whole = probes._phase_launch(xs, ws, 1, 8, False, "clamp", bf16_dots=bf16)
        counted = probes.chain_chunk(xs, ws, n_steps=1, depth=8, weights_per_depth=False,
                                     epilogue="clamp", bf16_dots=bf16)
        torch.cuda.synchronize()
        assert torch.equal(whole, counted)
