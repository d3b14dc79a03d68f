"""K6b's plain version against the JAX MLP grid kernel, and K6b's host-side code.

K6b is the grid mode of the fused MLP-VAE kernel
(``vae_training_tpu_torch/csrc/mlp_vae.cu``, a device table of rows): many
sweep rows, of mixed dims and uniform hidden widths, in one launch. The
same initial parameters (the JAX package's flax init, carried across with
``state_from_flax``) and the same numpy-drawn (x, z1, z2) streams per row go
through

  - the port's ``run_grid_chunk`` on CPU tensors, i.e. its plain version
    (one ``plain_mlp_fused_chunk`` per row on the packed buffers), and
  - the JAX package's Pallas MLP kernel in grid mode, in interpret mode with
    external noise (``run_mlp_fused_chunk(grid_n=...)``, the noise padded
    by ``kernel_test_helpers.pad_noise``, the rows stacked as
    tests/test_grid_kernel_equivalence.py:281-353 stacks them), or at full
    width (200|200|200) the JAX package's XLA path,

and must agree at ``tests/test_mlp_kernel.py``'s tolerances: losses
rtol/atol 3e-4, params rtol 1e-3 / atol 1e-5, Adam m rtol 1e-3 / atol 1e-6,
v rtol 1e-3 / atol 1e-9 (both sides are fp32; the stacks' sums are taken in
other orders). The CUDA kernel itself is held against this plain version
and against the solo kernel on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 18).
"""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_test_helpers import pad_noise, run_xla_steps  # noqa: E402
from vae_training_tpu.data import SigmoidDataset as JaxSigmoid  # noqa: E402
from vae_training_tpu.data import SphereDataset as JaxSphere  # noqa: E402
from vae_training_tpu.kernels import mlp_vae as jax_k5  # noqa: E402
from vae_training_tpu.kernels.linear_vae import _adam_state  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu_torch._scripts import sweep  # noqa: E402
from vae_training_tpu_torch.data import SigmoidDataset, SphereDataset  # noqa: E402
from vae_training_tpu_torch.kernels import dispatch  # noqa: E402
from vae_training_tpu_torch.kernels import mlp_vae as k5  # noqa: E402
from vae_training_tpu_torch.kernels.linear_vae import GridRow  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.runio.export import state_from_flax  # noqa: E402
from vae_training_tpu_torch.train import TrainState  # noqa: E402
from vae_training_tpu_torch.train.grid import GridTrainer  # noqa: E402
from vae_training_tpu_torch.train.mixed_grid import (  # noqa: E402
    MixedGridSweep,
    MixedSweepUnavailable,
    mixed_launch_eligible,
)

BATCH = 32
N_STEPS = 4
HIDDEN = (16, 16)
TOL = dict(loss=(3e-4, 3e-4), params=(1e-3, 1e-5), mu=(1e-3, 1e-6), nu=(1e-3, 1e-9))
# (kind, tdv, rows of (manifold dim, padding, latent)): mixed D and L
CASES = {
    "sphere-mixed-dims": ("sphere", True, [(3, 3, 6), (5, 8, 10)]),
    "sphere-no-tdv": ("sphere", False, [(3, 13, 8), (3, 3, 6)]),
    "sigmoid-dual-mixed-dims": ("sigmoid", True, [(3, 4, 6), (5, 2, 8)]),
}


def flat(tree):
    """Nested flax tree → {dotted name: numpy}."""
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_row(kind, dd, pad, ld, tdv, i, hidden="16|16", batch=BATCH, n_steps=N_STEPS,
            lr=1e-3, perturb=0.01):
    """Row i's JAX dataset, model, flax state (init shifted by perturb·(i + 1)
    per row) and numpy-drawn noise, x on the row's manifold."""
    if kind == "sphere":
        ds = JaxSphere(dim=dd, padding_dim=pad)
    else:
        ds = JaxSigmoid.create(2 + i, dimension=dd, padding_dimension=pad)
    D = ds.dimension
    model = jax_build_vae(data_dim=D, latent_dim=ld, encoder_layer_sizes=hidden,
                          decoder_layer_sizes=hidden, epsilon=-3.0, tunable_decoder_var=tdv,
                          dataset_name="sigmoid" if kind == "sigmoid" else None)
    tx = make_adam(lr)
    params = model.init(jax.random.PRNGKey(dd), jnp.zeros((1, D)), jnp.zeros((1, ld)),
                        jnp.zeros((1, D)))["params"]
    params = jax.tree_util.tree_map(lambda p: p + perturb * (i + 1), params)
    state = JaxTrainState.create(params=params, tx=tx, model_key=jax.random.PRNGKey(1),
                                 data_key=jax.random.PRNGKey(2))
    rs = np.random.RandomState(10 + i)
    z = rs.randn(n_steps, batch, dd).astype(np.float32)
    xs = np.zeros((n_steps, batch, D), np.float32)
    if kind == "sphere":
        xs[:, :, :dd] = z / np.linalg.norm(z, axis=-1, keepdims=True)
    else:
        xs[:, :, :dd] = z
        xs[:, :, dd] = 1 / (1 + np.exp(-(z @ np.asarray(ds.A))[..., 0]))
    noise = (xs, rs.randn(n_steps, batch, ld).astype(np.float32),
             rs.randn(n_steps, batch, D).astype(np.float32))
    return ds, model, tx, state, noise, (D, ld, dd)


def port_state(jstate):
    adam = _adam_state(jstate.opt_state)
    return state_from_flax(jax.device_get(jstate.params), jax.device_get(adam.mu),
                           jax.device_get(adam.nu), int(adam.count))


def grid_row(kind, ds, dims):
    D, L, dd = dims
    a = torch.tensor(np.asarray(ds.A)) if kind == "sigmoid" else None
    return GridRow(D, L, dd, dd, a, step0=0, t0=0, data_seed=1, model_seed=2)


def assert_row_close(i, state, losses, ref_params, ref_mu, ref_nu, ref_losses):
    np.testing.assert_allclose(losses, ref_losses, *TOL["loss"], err_msg=f"row {i} losses")
    for got, ref, tol in ((state.params, ref_params, "params"), (state.m, ref_mu, "mu"),
                          (state.v, ref_nu, "nu")):
        ref = flat(ref)
        assert set(got) == set(ref)
        for name, val in got.items():
            np.testing.assert_allclose(val.numpy(), ref[name], *TOL[tol],
                                       err_msg=f"row {i} {tol} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k6b_matches_jax_grid_kernel(case):
    kind, tdv, specs = CASES[case]
    dual = kind == "sigmoid"
    rows = [jax_row(kind, *spec, tdv, i) for i, spec in enumerate(specs)]

    # the JAX grid kernel: one interpret-mode launch over every row
    layer_dims = [(jax_k5._layer_dims(m.encoder_features, dims[0]),
                   jax_k5._layer_dims(m.decoder_features, dims[1]))
                  for _, m, _, _, _, dims in rows]
    packed = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0),
        *[jax.tree_util.tree_map(lambda x: x[None],
                                 jax_k5.pack_mlp_state(st, e, d, tdv, dual=dual))
          for (_, _, _, st, _, _), (e, d) in zip(rows, layer_dims)])
    seeds = jnp.asarray([[7, 0, *dims] for *_, dims in rows], jnp.int32)
    padded = [pad_noise(*noise, N_STEPS, batch=BATCH, lane=jax_k5.LANE)
              for *_, noise, _ in rows]
    noise_g = tuple(jnp.stack([p[j] for p in padded]) for j in range(3))
    D0, L0, dd0 = rows[0][5]
    new_packed, jlosses = jax_k5.run_mlp_fused_chunk(
        n_steps=N_STEPS, seed_and_t0=seeds,
        a_t=jnp.zeros((len(rows), jax_k5.LANE, jax_k5.LANE), jnp.float32), packed=packed,
        batch=BATCH, data_dim=D0, latent_dim=L0, enc_dims=layer_dims[0][0],
        dec_dims=layer_dims[0][1], dataset_kind=kind, intrinsic_dim=dd0, var_added=0.0,
        eps_const=-3.0, tdv=tdv, lr=1e-3, external_noise=noise_g, interpret=True,
        grid_n=len(rows), dual=dual)
    jlosses = np.asarray(jlosses)

    # the port: K6b's wrapper on CPU tensors runs its plain version
    states = [port_state(st) for _, _, _, st, _, _ in rows]
    grows = [grid_row(kind, ds, dims) for ds, *_, dims in rows]
    p, m, v = k5.pack_rows(states, grows, HIDDEN, HIDDEN, dual)
    calls = k5.plain_grid_chunk.calls
    losses = k5.run_grid_chunk(
        p, m, v, grows, n_steps=N_STEPS, batch=BATCH, enc_hidden=HIDDEN, dec_hidden=HIDDEN,
        kind=kind, eps_const=-3.0, tdv=tdv, lr=1e-3, dual=dual,
        external_noise=[tuple(map(torch.as_tensor, n)) for *_, n, _ in rows])
    assert k5.plain_grid_chunk.calls == calls + 1
    assert tuple(losses.shape) == (len(rows), N_STEPS)
    states = k5.unpack_rows(states, p, m, v, grows, N_STEPS, HIDDEN, HIDDEN, dual)

    for i, ((_, _, _, jstate, _, dims), state, (e, d)) in enumerate(
            zip(rows, states, layer_dims)):
        row_packed = jax.tree_util.tree_map(lambda x: x[i], new_packed)
        kstate = jax_k5.unpack_mlp_state(jstate, row_packed, N_STEPS, e, d, tdv, dims[1],
                                         dual=dual)
        adam = _adam_state(kstate.opt_state)
        assert state.count == int(adam.count) == N_STEPS and state.step == N_STEPS
        assert_row_close(i, state, losses[i].numpy(), kstate.params, adam.mu, adam.nu,
                         jlosses[i])


@pytest.mark.parametrize("kind", ["sphere", "sigmoid"])
def test_plain_k6b_matches_jax_xla_at_full_width(kind):
    """One row at the sweep's full width (200|200|200, batch 100, the
    sweep's lr 1e-4 and the flax init) through K6b's wrapper on the CPU,
    against the JAX package's XLA path."""
    n_steps, batch = 3, 100
    ds, model, tx, jstate, noise, dims = jax_row(kind, 3, 3, 6, True, 0, "200|200|200",
                                                 batch, n_steps, lr=1e-4, perturb=0.0)
    dual = kind == "sigmoid"
    hidden = (200, 200, 200)
    states = [port_state(jstate)]
    grows = [grid_row(kind, ds, dims)]
    p, m, v = k5.pack_rows(states, grows, hidden, hidden, dual)
    losses = k5.run_grid_chunk(p, m, v, grows, n_steps=n_steps, batch=batch, enc_hidden=hidden,
                               dec_hidden=hidden, kind=kind, eps_const=-3.0, tdv=True, lr=1e-4,
                               dual=dual, external_noise=[tuple(map(torch.as_tensor, noise))])
    state = k5.unpack_rows(states, p, m, v, grows, n_steps, hidden, hidden, dual)[0]
    params, opt, ref_losses = run_xla_steps(model, tx, jstate, *map(jnp.asarray, noise))
    adam = _adam_state(opt)
    assert state.count == int(adam.count) == n_steps
    assert_row_close(0, state, losses[0].numpy(), params, adam.mu, adam.nu, ref_losses)


def _port_rows(kind, specs, hidden=HIDDEN):
    """Port-side rows of mixed dims from the port's own init: states and
    GridRows with distinct seeds and counters."""
    states, grows = [], []
    for i, (dd, pad, ld) in enumerate(specs):
        ds = SphereDataset(dd, pad) if kind == "sphere" else SigmoidDataset.create(40 + i, dd, pad)
        model = build_vae(data_dim=ds.dimension, latent_dim=ld,
                          encoder_layer_sizes="|".join(map(str, hidden)),
                          decoder_layer_sizes="|".join(map(str, hidden)), epsilon=-3.0,
                          tunable_decoder_var=True,
                          dataset_name="sigmoid" if kind == "sigmoid" else None)
        model.init_parameters(i)
        state = TrainState.create(dict(model.named_parameters()), 100 + i, 200 + i)
        state.step, state.count = 7 * i, 5 * i
        states.append(state)
        grows.append(GridRow(ds.dimension, ld, ds.intrinsic_dim, ds.dim,
                             ds.A if kind == "sigmoid" else None, step0=state.step,
                             t0=state.count, data_seed=state.data_seed,
                             model_seed=state.model_seed))
    return states, grows


MIXED = [(3, 3, 6), (5, 8, 10), (3, 13, 8)]


@pytest.mark.parametrize("kind", ["sphere", "sigmoid"])
def test_k6b_grid_row_equals_solo_plain_chunk_bitwise(kind):
    """Row i of a mixed-dims grid chunk equals a solo plain_mlp_fused_chunk
    on row i's inputs bitwise (in-sampler noise, each row's own seeds and
    counters): this pins the row offsets of the packed buffers."""
    dual = kind == "sigmoid"
    states, grows = _port_rows(kind, MIXED)
    p, m, v = k5.pack_rows(states, grows, HIDDEN, HIDDEN, dual)
    losses = k5.run_grid_chunk(p, m, v, grows, n_steps=3, batch=BATCH, enc_hidden=HIDDEN,
                               dec_hidden=HIDDEN, kind=kind, eps_const=-3.0, tdv=True, lr=1e-3,
                               dual=dual)
    views = k5.row_views(p, m, v, grows, HIDDEN, HIDDEN, dual)
    for i, (state, r) in enumerate(zip(states, grows)):
        enc, dec = k5.row_widths(r, HIDDEN, HIDDEN)
        sp, sm, sv = k5.pack_state(state, enc, dec, dual)
        solo = k5.plain_mlp_fused_chunk(
            sp, sm, sv, r.a, n_steps=3, batch=BATCH, enc_widths=enc, dec_widths=dec, kind=kind,
            intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=r.step0,
            t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed, var_added=0.0,
            eps_const=-3.0, tdv=True, lr=1e-3, dual=dual)
        assert torch.equal(losses[i], solo), f"row {i} losses"
        for got, want in zip(views[i], (sp, sm, sv)):
            assert torch.equal(got, want), f"row {i} state"


@pytest.mark.parametrize("dual", [False, True], ids=["sphere", "sigmoid-dual"])
def test_k6b_packed_rows_round_trip_bitwise(dual):
    states, grows = _port_rows("sigmoid" if dual else "sphere", MIXED)
    offs = k5.row_offsets(grows, HIDDEN, HIDDEN, dual)
    assert offs == [0] + list(np.cumsum([k5.n_params(*k5.row_widths(r, HIDDEN, HIDDEN), dual)
                                         for r in grows]))
    p, m, v = k5.pack_rows(states, grows, HIDDEN, HIDDEN, dual)
    assert p.shape == m.shape == v.shape == (offs[-1],)
    for i, (rp, _, _) in enumerate(k5.row_views(p, m, v, grows, HIDDEN, HIDDEN, dual)):
        assert torch.equal(rp, k5.pack_state(states[i], *k5.row_widths(grows[i], HIDDEN, HIDDEN),
                                             dual)[0])
    fresh = [TrainState(params={k: torch.zeros_like(t) for k, t in s.params.items()},
                        m={k: torch.zeros_like(t) for k, t in s.m.items()},
                        v={k: torch.zeros_like(t) for k, t in s.v.items()},
                        count=s.count, step=s.step, data_seed=s.data_seed,
                        model_seed=s.model_seed) for s in states]
    out = k5.unpack_rows(fresh, p, m, v, grows, 3, HIDDEN, HIDDEN, dual)
    for a, b in zip(out, states):
        assert a.step == b.step + 3 and a.count == b.count + 3
        assert any(n.startswith("SigDecoder") for n in a.params) == dual
        for tree_a, tree_b in ((a.params, b.params), (a.m, b.m), (a.v, b.v)):
            for name in tree_b:
                assert torch.equal(tree_a[name], tree_b[name]), name


def _cfg(**kw):
    base = dict(batch_size=100, adam_dtype="f32", device="cuda", kernels="auto", nojit=False,
                learning_rate=1e-4, num_batches=100, n_print=50, n_plot=100)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture
def fake_h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))


def _sphere_sweep():
    datasets = [SphereDataset(dd, pd) for dd, pd, _ in sweep.SPHERE_GRID] * 3
    models = [build_vae(data_dim=d.dimension, latent_dim=ld, encoder_layer_sizes="200|200|200",
                        decoder_layer_sizes="200|200|200", epsilon=-3.0,
                        tunable_decoder_var=True)
              for d, (_, _, ld) in zip(datasets, sweep.SPHERE_GRID * 3)]
    return models, datasets


def _sigmoid_mlp_grid():
    datasets = [SigmoidDataset.create(s, 3, 3) for s in (69, 24, 48)]
    models = [build_vae(data_dim=7, latent_dim=6, encoder_layer_sizes="200|200|200",
                        decoder_layer_sizes="200|200|200", epsilon=-3.0,
                        tunable_decoder_var=True, dataset_name="sigmoid")] * 3
    return models, datasets


def test_grid_supported_takes_the_sphere_sweep(fake_h100):
    models, datasets = _sphere_sweep()
    ok, why = k5.grid_supported(models, datasets, _cfg())
    assert ok and why == ("15 ReLU MLP VAE rows on sphere, hidden widths 200|200|200 / "
                          "200|200|200, up to 176054 parameters a row")
    # its dims: D 6–21, L 6–16
    assert ({d.dimension for d in datasets}, {m.latent_dim for m in models}) == (
        {6, 16, 21, 10, 14}, {6, 8, 16, 10, 13})
    ok, why = k5.grid_supported(*_sigmoid_mlp_grid(), _cfg())
    assert ok and why.startswith("3 ReLU MLP VAE rows on sigmoid with the dual decoder")


@pytest.mark.parametrize("change,match", [
    ("hidden widths", r"row 1 differs from row 0 in hidden widths \(\(\(200, 64\)"),
    ("layer counts", "row 1 differs from row 0 in layer counts"),
    ("epsilon", "row 1 differs from row 0 in epsilon"),
    ("dual on sphere", "row 0: the dual decoder expects the sigmoid dataset"),
    ("pure linear", "row 0: pure-linear configs use the linear kernel"),
    ("device", "no CUDA device is available"),
])
def test_grid_supported_names_the_failing_row(monkeypatch, change, match):
    def mlp(enc="200|200|200", dec="200|200|200", eps=-3.0, name=None, D=6):
        return build_vae(data_dim=D, latent_dim=6, encoder_layer_sizes=enc,
                         decoder_layer_sizes=dec, epsilon=eps, tunable_decoder_var=True,
                         dataset_name=name)

    models, datasets = [mlp(), mlp()], [SphereDataset(3, 3), SphereDataset(3, 3)]
    if change == "hidden widths":
        models[1] = mlp(enc="200|64")
        models[0] = mlp(enc="200|200")
    elif change == "layer counts":
        models[1] = mlp(dec="200")
    elif change == "epsilon":
        models[1] = mlp(eps=-1.0)
    elif change == "dual on sphere":
        models = [mlp(name="sigmoid")] * 2
    elif change == "pure linear":
        models = [mlp(enc="", dec="")] * 2
    if change == "device":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    ok, why = k5.grid_supported(models, datasets, _cfg())
    assert not ok
    assert re.search(match, why), why


def test_make_grid_chunk_names_k6b(fake_h100, capsys):
    models, datasets = _sphere_sweep()
    dispatch.make_grid_chunk(models, datasets, _cfg(kernels="cuda"))
    assert ("[kernels] cuda: K6b, the grid mode of the fused MLP-VAE kernel, 15 rows in one "
            "launch a chunk (15 ReLU MLP VAE rows on sphere") in capsys.readouterr().out
    dispatch.make_grid_chunk(*_sigmoid_mlp_grid(), _cfg())
    assert ("[kernels] cuda: K6b, the grid mode of the fused MLP-VAE kernel, 3 rows in one "
            "launch a chunk (3 ReLU MLP VAE rows on sigmoid with the dual decoder"
            ) in capsys.readouterr().out
    dispatch.make_grid_chunk(models, datasets, _cfg(kernels="torch"))
    assert ("[kernels] torch: plain PyTorch path, row by row for 15 rows (--kernels torch)"
            in capsys.readouterr().out)
    # rows K6b refuses, with --kernels cuda: both kernels' reasons
    mixed = models[:1] + [build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes="64",
                                    decoder_layer_sizes="64", epsilon=-3.0,
                                    tunable_decoder_var=True)]
    with pytest.raises(RuntimeError, match="linear kernel: row 0: .*; MLP kernel: row 1 "
                                           "differs from row 0 in layer counts"):
        dispatch.make_grid_chunk(mixed, datasets[:2], _cfg(kernels="cuda"))


def test_mixed_grid_sweep_takes_the_sphere_sweep(tmp_path, capsys):
    def groups(kernels):
        cfgs = {}
        for cfg in sweep.sweep_configs("sphere", str(tmp_path), 2, kernels, device="cpu"):
            cfgs.setdefault((cfg.dataset_dimension, cfg.padding_dim, cfg.latent_dimension), cfg)
        return [GridTrainer(c, sweep.SWEEP_SEEDS["sphere"], build_chunk=False)
                for c in cfgs.values()]

    family, why = mixed_launch_eligible(groups("auto"))
    assert family == "mlp" and why.startswith("15 ReLU MLP VAE rows on sphere")
    MixedGridSweep(groups("auto"))
    assert ("[kernels] plain: K6b's plain version on the CPU, 15 rows a chunk, one plain chunk "
            "a row (device 'cpu' is not a CUDA device; 15 ReLU MLP VAE rows on sphere"
            ) in capsys.readouterr().out
    with pytest.raises(MixedSweepUnavailable, match="the torch path trains rows one by one"):
        MixedGridSweep(groups("torch"))
