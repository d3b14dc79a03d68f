"""K6a's plain version against the JAX grid kernel, and K6a's host-side code.

K6a is the grid mode of the fused linear kernel
(``vae_training_tpu_torch/csrc/linear_vae.cu``, ``linear_vae_grid_chunk``):
many sweep rows, of mixed dims, in one launch. The same initial parameters
(the JAX package's flax init, carried across with ``state_from_flax``) and
the same numpy-drawn (x, z1, z2) streams per row go through

  - the port's ``run_grid_chunk`` on CPU tensors, i.e. its plain version
    (one ``plain_fused_chunk`` per row on the packed buffers), and
  - the JAX package's Pallas kernel in grid mode, in interpret mode with
    external noise (``run_fused_chunk(grid_n=...)``, the noise padded by
    ``kernel_test_helpers.pad_noise``),

and must agree at ``tests/test_pallas_kernel.py``'s tolerances: losses
rtol/atol 2e-4, params rtol 5e-4 / atol 5e-5, Adam m rtol 5e-4 / atol 1e-6,
v rtol 5e-4 / atol 1e-7 (both sides are fp32; only summation order and
libm ulps differ). The CUDA kernel itself is held against this plain version
and against the solo kernel on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_test_helpers import pad_noise  # noqa: E402
from vae_training_tpu.data import LinearGaussianDataset as JaxLinear  # noqa: E402
from vae_training_tpu.data import SigmoidDataset as JaxSigmoid  # noqa: E402
from vae_training_tpu.kernels import linear_vae as jax_k1  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu_torch.data import (  # noqa: E402
    LinearGaussianDataset,
    SigmoidDataset,
    SphereDataset,
)
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.runio.export import state_from_flax  # noqa: E402
from vae_training_tpu_torch.train import TrainState  # noqa: E402

BATCH = 32
N_STEPS = 4
TOL = dict(loss=(2e-4, 2e-4), params=(5e-4, 5e-5), mu=(5e-4, 1e-6), nu=(5e-4, 1e-7))
# (kind, tdv, rows of (manifold dim, padding, latent))
CASES = {
    "linear-tdv": ("linear", True, [(3, 9, 20)] * 3),
    "linear-no-tdv": ("linear", False, [(3, 9, 20)] * 3),
    "sigmoid-dual": ("sigmoid", True, [(3, 8, 20)] * 3),
    "linear-mixed-dims": ("linear", True, [(3, 9, 20), (4, 2, 10)]),
}


def flat(tree):
    """Nested flax tree → {dotted name: numpy}."""
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_row(kind, dd, pad, ld, tdv, i):
    """Row i's JAX dataset, flax state (init perturbed per row, as the JAX
    grid suite does) and numpy-drawn noise."""
    if kind == "linear":
        ds = JaxLinear.create(2, dimension=dd, intrinsic_dimension=dd, padding_dimension=pad)
    else:
        ds = JaxSigmoid.create(2, dimension=dd, padding_dimension=pad)
    D = ds.dimension
    model = jax_build_vae(data_dim=D, latent_dim=ld, encoder_layer_sizes="",
                          decoder_layer_sizes="", epsilon=-1.0, tunable_decoder_var=tdv,
                          dataset_name="sigmoid" if kind == "sigmoid" else None)
    params = model.init(jax.random.PRNGKey(dd), jnp.zeros((1, D)), jnp.zeros((1, ld)),
                        jnp.zeros((1, D)))["params"]
    params = jax.tree_util.tree_map(lambda p: p + 0.01 * (i + 1), params)
    state = JaxTrainState.create(params=params, tx=make_adam(1e-3),
                                 model_key=jax.random.PRNGKey(1),
                                 data_key=jax.random.PRNGKey(2))
    rs = np.random.RandomState(10 + i)
    z = rs.randn(N_STEPS, BATCH, dd).astype(np.float32)
    if kind == "linear":
        xs = np.zeros((N_STEPS, BATCH, D), np.float32)
        xs[:, :, :dd] = z @ np.asarray(ds.A).T
    else:
        sig = 1 / (1 + np.exp(-(z @ np.asarray(ds.A))))
        xs = np.concatenate([z, sig, np.zeros((N_STEPS, BATCH, pad), np.float32)], axis=-1)
    noise = (xs.astype(np.float32), rs.randn(N_STEPS, BATCH, ld).astype(np.float32),
             rs.randn(N_STEPS, BATCH, D).astype(np.float32))
    return ds, state, noise, (D, ld, dd)


def port_state(jstate):
    adam = jax_k1._adam_state(jstate.opt_state)
    return state_from_flax(jax.device_get(jstate.params), jax.device_get(adam.mu),
                           jax.device_get(adam.nu), int(adam.count))


def grid_row(ds, dims):
    D, L, dd = dims
    return k1.GridRow(D, L, dd, dd, torch.tensor(np.asarray(ds.A)), step0=0, t0=0,
                      data_seed=1, model_seed=2)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k6a_matches_jax_grid_kernel(case):
    kind, tdv, specs = CASES[case]
    dual = kind == "sigmoid"
    rows = [jax_row(kind, *spec, tdv, i) for i, spec in enumerate(specs)]

    # the JAX grid kernel: one interpret-mode launch over every row
    bufs = [jax_k1.pack_state(st, dims[0], dims[1], tdv, dual=dual)
            for _, st, _, dims in rows]
    stacked = tuple(jnp.stack([b[j] for b in bufs]) for j in range(len(bufs[0])))
    padded = [pad_noise(*noise, N_STEPS, batch=BATCH, lane=jax_k1.N) for _, _, noise, _ in rows]
    noise_g = tuple(jnp.stack([p[j] for p in padded]) for j in range(3))
    seeds = jnp.asarray([[123, 0, *dims] for *_, dims in rows], jnp.int32)
    D0, L0, dd0 = rows[0][3]
    new_bufs, jlosses = jax_k1.run_fused_chunk(
        n_steps=N_STEPS, seed_and_t0=seeds,
        a_t=jnp.zeros((len(rows), jax_k1.N, jax_k1.N), jnp.float32), buffers=stacked,
        batch=BATCH, data_dim=D0, latent_dim=L0, intrinsic_dim=dd0, var_added=0.0,
        eps_const=-1.0, tdv=tdv, lr=1e-3, dataset_kind=kind, dual=dual,
        external_noise=noise_g, interpret=True, grid_n=len(rows))
    jlosses = np.asarray(jlosses)

    # the port: K6a's wrapper on CPU tensors runs its plain version
    states = [port_state(st) for _, st, _, _ in rows]
    grows = [grid_row(ds, dims) for ds, _, _, dims in rows]
    p, m, v = k1.pack_rows(states, grows, dual)
    calls = k1.plain_grid_chunk.calls
    losses = k1.run_grid_chunk(
        p, m, v, grows, n_steps=N_STEPS, batch=BATCH, eps_const=-1.0, tdv=tdv, lr=1e-3,
        dual=dual, external_noise=[tuple(map(torch.as_tensor, n)) for _, _, n, _ in rows])
    assert k1.plain_grid_chunk.calls == calls + 1
    assert tuple(losses.shape) == (len(rows), N_STEPS)
    states = k1.unpack_rows(states, p, m, v, grows, N_STEPS, dual)

    for i, ((_, jstate, _, dims), state) in enumerate(zip(rows, states)):
        np.testing.assert_allclose(losses[i].numpy(), jlosses[i], *TOL["loss"],
                                   err_msg=f"row {i} losses")
        kstate = jax_k1.unpack_state(jstate, tuple(b[i] for b in new_bufs), N_STEPS,
                                     dims[0], dims[1], tdv, dual=dual)
        adam = jax_k1._adam_state(kstate.opt_state)
        assert state.count == int(adam.count) == N_STEPS and state.step == N_STEPS
        for got, ref, tol in ((state.params, kstate.params, "params"),
                              (state.m, adam.mu, "mu"), (state.v, adam.nu, "nu")):
            ref = flat(ref)
            assert set(got) == set(ref)
            for name, val in got.items():
                np.testing.assert_allclose(val.numpy(), ref[name], *TOL[tol],
                                           err_msg=f"row {i} {tol} {name}")


def _port_rows(dual, specs, seed=0):
    """Port-side rows of mixed dims from the port's own init: states and
    GridRows with distinct seeds and counters."""
    states, grows = [], []
    for i, (dd, pad, ld) in enumerate(specs):
        if dual:
            ds = SigmoidDataset.create(40 + i, dd, pad)
        else:
            ds = LinearGaussianDataset.create(40 + i, dd, dd, pad)
        model = build_vae(data_dim=ds.dimension, latent_dim=ld, epsilon=-1.0,
                          tunable_decoder_var=True, dataset_name="sigmoid" if dual else None)
        model.init_parameters(seed + i)
        state = TrainState.create(dict(model.named_parameters()), 100 + i, 200 + i)
        state.step, state.count = 7 * i, 5 * i
        states.append(state)
        grows.append(k1.GridRow(ds.dimension, ld, ds.intrinsic_dim, ds.dim, ds.A,
                                step0=state.step, t0=state.count, data_seed=state.data_seed,
                                model_seed=state.model_seed))
    return states, grows


MIXED = [(3, 9, 20), (4, 2, 10), (12, 8, 10)]


def test_packed_rows_round_trip_bitwise():
    states, grows = _port_rows(False, MIXED)
    offs = k1.row_offsets(grows)
    assert offs == [0] + list(np.cumsum([k1.n_params(r.data_dim, r.latent_dim)
                                         for r in grows]))
    p, m, v = k1.pack_rows(states, grows)
    assert p.shape == m.shape == v.shape == (offs[-1],)
    for i, (rp, _, _) in enumerate(k1.row_views(p, m, v, grows)):
        assert torch.equal(rp, k1.pack_state(states[i], grows[i].data_dim,
                                             grows[i].latent_dim)[0])
    fresh = [TrainState(params={k: torch.zeros_like(t) for k, t in s.params.items()},
                        m={k: torch.zeros_like(t) for k, t in s.m.items()},
                        v={k: torch.zeros_like(t) for k, t in s.v.items()},
                        count=s.count, step=s.step, data_seed=s.data_seed,
                        model_seed=s.model_seed) for s in states]
    out = k1.unpack_rows(fresh, p, m, v, grows, 3)
    for a, b in zip(out, states):
        assert a.step == b.step + 3 and a.count == b.count + 3
        for tree_a, tree_b in ((a.params, b.params), (a.m, b.m), (a.v, b.v)):
            for name in tree_b:
                assert torch.equal(tree_a[name], tree_b[name]), name


@pytest.mark.parametrize("dual", [False, True], ids=["K1-rows", "K2-rows"])
def test_grid_row_equals_solo_plain_chunk_bitwise(dual):
    """Row i of a mixed-dims grid chunk equals a solo plain_fused_chunk on
    row i's inputs bitwise (in-sampler noise, each row's own seeds and
    counters): this pins the row offsets of the packed buffers."""
    specs = [(3, 8, 20), (5, 5, 10), (7, 20, 24)] if dual else MIXED
    states, grows = _port_rows(dual, specs)
    p, m, v = k1.pack_rows(states, grows, dual)
    losses = k1.run_grid_chunk(p, m, v, grows, n_steps=3, batch=BATCH, eps_const=-1.0,
                               tdv=True, lr=1e-3, dual=dual)
    for i, (state, r) in enumerate(zip(states, grows)):
        sp, sm, sv = k1.pack_state(state, r.data_dim, r.latent_dim, dual)
        solo = k1.plain_fused_chunk(
            sp, sm, sv, r.a, n_steps=3, batch=BATCH, data_dim=r.data_dim,
            latent_dim=r.latent_dim, intrinsic_dim=r.intrinsic_dim,
            manifold_dim=r.manifold_dim, step0=r.step0, t0=r.t0, data_seed=r.data_seed,
            model_seed=r.model_seed, var_added=0.0, eps_const=-1.0, tdv=True, lr=1e-3,
            dual=dual)
        assert torch.equal(losses[i], solo), f"row {i} losses"
        for got, want in zip(k1.row_views(p, m, v, grows, dual)[i], (sp, sm, sv)):
            assert torch.equal(got, want), f"row {i} state"


def _cfg(**kw):
    base = dict(batch_size=100, adam_dtype="f32", device="cuda", kernels="auto", nojit=False,
                learning_rate=1e-3, num_batches=100, n_print=50, n_plot=100)
    base.update(kw)
    return SimpleNamespace(**base)


def _lin(dd, pd, ld, eps=-1.0, tdv=True):
    ds = LinearGaussianDataset.create(2, dd, dd, pd)
    return build_vae(data_dim=ds.dimension, latent_dim=ld, epsilon=eps,
                     tunable_decoder_var=tdv), ds


@pytest.fixture
def fake_h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))


def test_grid_supported_takes_the_mixed_linear_sweep(fake_h100):
    from vae_training_tpu_torch._scripts.sweep import LINEAR_GRID, SIGMOID_GRID

    rows = [_lin(dd, pd, ld) for dd, pd, ld in LINEAR_GRID] * 3
    ok, why = k1.grid_supported([r[0] for r in rows], [r[1] for r in rows], _cfg())
    assert ok and "21 pure-linear VAE on linear_gaussian rows" in why
    sig = [SigmoidDataset.create(69, dd, pd) for dd, pd, _ in SIGMOID_GRID]
    models = [build_vae(data_dim=d.dimension, latent_dim=ld, epsilon=-3.0,
                        tunable_decoder_var=True, dataset_name="sigmoid")
              for d, (_, _, ld) in zip(sig, SIGMOID_GRID)]
    ok, why = k1.grid_supported(models, sig, _cfg(learning_rate=1e-4))
    assert ok and "dual-decoder" in why
    # the largest sigmoid row sets the launch's shared memory
    assert str(k1.smem_bytes(100, 28, 24, 7, 7, dual=True)) in why


@pytest.mark.parametrize("change,match", [
    ("epsilon", "row 1 differs from row 0 in epsilon"),
    ("tdv", "row 1 differs from row 0 in -tdv"),
    ("cadence", "row 1 differs from row 0 in n_print"),
    ("lr", "row 1 differs from row 0 in learning rate"),
    ("dataset", "row 1 differs from row 0 in dataset"),
    ("mlp", "row 1: the fused kernel supports 0-hidden-layer"),
    ("smem", "row 1: state and activations need"),
    ("device", "no CUDA device is available"),
])
def test_grid_supported_names_the_failing_row(monkeypatch, change, match):
    m0, d0 = _lin(3, 9, 20)
    m1, d1 = _lin(4, 2, 10)
    cfgs = [_cfg(), _cfg()]
    if change == "epsilon":
        m1, d1 = _lin(4, 2, 10, eps=-3.0)
    elif change == "tdv":
        m1, d1 = _lin(4, 2, 10, tdv=False)
    elif change == "cadence":
        cfgs[1] = _cfg(n_print=10)
    elif change == "lr":
        cfgs[1] = _cfg(learning_rate=1e-4)
    elif change == "dataset":
        d1 = SphereDataset(3, 3)
        m1 = build_vae(data_dim=6, latent_dim=6, epsilon=-1.0, tunable_decoder_var=True)
    elif change == "mlp":
        m1 = build_vae(data_dim=d1.dimension, latent_dim=10, encoder_layer_sizes="16",
                       epsilon=-1.0, tunable_decoder_var=True)
    elif change == "smem":
        m1, d1 = _lin(4, 2, 300)
    if change == "device":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfgs = [_cfg(device="cuda:0")] * 2
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    ok, why = k1.grid_supported([m0, m1], [d0, d1], cfgs)
    assert not ok
    assert re.search(match, why), why


def test_grid_supported_on_the_cpu_runs_the_plain_version():
    m0, d0 = _lin(3, 9, 20)
    ok, why = k1.grid_supported([m0, m0], [d0, d0], _cfg(device="cpu"))
    assert ok and "2 pure-linear" in why
    ok, why = k1.grid_supported([m0], [d0, d0], _cfg(device="cpu"))
    assert not ok and "one model, dataset and config a row" in why
