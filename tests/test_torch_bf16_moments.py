"""K4, the bf16 Adam moments (``--adam_dtype bf16``), on the CPU.

The rule (``train/state.py:moment_dtype``): the moments of every weight
matrix (ndim ≥ 2) are stored in bfloat16; biases, ``epsilon_p`` and
``epsilon`` keep float32 moments. Each step computes m and v in float32,
rounds them to bfloat16 (round to nearest even) and feeds the rounded
values to the update: the JAX package's ``_scale_by_adam_bf16``
(``vae_training_tpu/train/state.py:48-97``) and the bf16 branch of its
kernels' ``_adam`` (``vae_training_tpu/kernels/linear_vae.py:188-218``).

The same initial parameters (the JAX package's flax init, carried across
with ``state_from_flax``) and the same numpy-drawn (x, z1, z2) streams go
through the port's torch path and its kernels' plain versions on CPU
tensors, and through the JAX package's XLA path (``make_adam(lr, "bf16")``
+ ``run_xla_steps``) and its Pallas kernels in interpret mode with bf16
buffers. Tolerances: linear losses 2e-4, params 5e-4 / 5e-5; MLP losses
3e-4, params 1e-3 / 1e-5; float32 moments at tests/test_pallas_kernel.py's
and tests/test_mlp_kernel.py's tolerances; bfloat16 moments by
``kernel_test_helpers.assert_adam_moments`` in strict mode (at most 1 bf16
ulp above the absolute floor, at least 95% of the elements bitwise). The
CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 22-24).
"""

import os
import pickle
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_test_helpers import assert_adam_moments, pad_noise, run_xla_steps  # noqa: E402
from vae_training_tpu.data import LinearGaussianDataset as JaxLinear  # noqa: E402
from vae_training_tpu.data import SigmoidDataset as JaxSigmoid  # noqa: E402
from vae_training_tpu.data import SphereDataset as JaxSphere  # noqa: E402
from vae_training_tpu.kernels import linear_vae as jax_k1  # noqa: E402
from vae_training_tpu.kernels import mlp_vae as jax_k5  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.data import LinearGaussianDataset, SphereDataset  # noqa: E402
from vae_training_tpu_torch.kernels import dispatch  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.kernels import mlp_vae as k5  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.runio import checkpoint as ck  # noqa: E402
from vae_training_tpu_torch.runio import export  # noqa: E402
from vae_training_tpu_torch.train import TrainState, moment_dtype, train_chunk  # noqa: E402
from vae_training_tpu_torch.train.loop import Trainer  # noqa: E402

BATCH = 32
LIN_TOL = dict(loss=(2e-4, 2e-4), params=(5e-4, 5e-5), mu=(5e-4, 1e-6), nu=(5e-4, 1e-7))
MLP_TOL = dict(loss=(3e-4, 3e-4), params=(1e-3, 1e-5), mu=(1e-3, 1e-6), nu=(1e-3, 1e-9))
BF16, F32 = torch.bfloat16, torch.float32
ROW1 = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
        "-ow", "--latent_dim", "20", "--padding_dim", "9", "-dd", "3", "--epsilon", "-1",
        "-tdv", "-lr", "1e-3", "--device", "cpu", "--n_print", "10", "--n_plot", "10"]


# --- the references: JAX setups, the port's state, the comparison -------------

def jax_case(kind, tdv, hidden="", lr=1e-3, seed=0, dims=(3, 9, 20)):
    """(dataset, model, bf16 optax chain, flax state) of one JAX config:
    linear_gaussian, sigmoid (dual decoder) or sphere; ``hidden`` = "" is
    the pure-linear net of K1/K2."""
    dd, pad, ld = dims
    if kind == "linear":
        ds = JaxLinear.create(2, dimension=dd, intrinsic_dimension=dd, padding_dimension=pad)
    elif kind == "sigmoid":
        ds = JaxSigmoid.create(2 + seed, dimension=dd, padding_dimension=pad)
    else:
        ds = JaxSphere(dim=dd, padding_dim=pad)
    D = ds.dimension
    model = jax_build_vae(data_dim=D, latent_dim=ld, encoder_layer_sizes=hidden,
                          decoder_layer_sizes=hidden, epsilon=-1.0 if not hidden else -3.0,
                          tunable_decoder_var=tdv,
                          dataset_name="sigmoid" if kind == "sigmoid" else None)
    tx = make_adam(lr, "bf16")
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, D)), jnp.zeros((1, ld)),
                        jnp.zeros((1, D)))["params"]
    params = jax.tree_util.tree_map(lambda p: p + 0.01 * seed, params)
    state = JaxTrainState.create(params=params, tx=tx, model_key=jax.random.PRNGKey(1),
                                 data_key=jax.random.PRNGKey(2))
    return ds, model, tx, state


def jax_noise(ds, kind, n_steps, latent, seed=0):
    rs = np.random.RandomState(seed)
    D, dd = ds.dimension, ds.dim
    xs = np.zeros((n_steps, BATCH, D), np.float32)
    z = rs.randn(n_steps, BATCH, ds.intrinsic_dim if kind == "linear" else dd)
    z = z.astype(np.float32)
    if kind == "linear":
        xs[:, :, :dd] = z @ np.asarray(ds.A).T
    elif kind == "sigmoid":
        xs[:, :, :dd] = z
        xs[:, :, dd] = 1 / (1 + np.exp(-(z @ np.asarray(ds.A))[..., 0]))
    else:
        xs[:, :, :dd] = z / np.linalg.norm(z, axis=-1, keepdims=True)
    return (xs, rs.randn(n_steps, BATCH, latent).astype(np.float32),
            rs.randn(n_steps, BATCH, D).astype(np.float32))


def port_state(jstate):
    adam = jax_k1._adam_state(jstate.opt_state)
    return export.state_from_flax(jax.device_get(jstate.params), jax.device_get(adam.mu),
                                  jax.device_get(adam.nu), int(adam.count))


def named(tree):
    """Nested flax tree → {dotted name: jax array}, dtypes kept."""
    return {".".join(str(k.key) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def as_jax(tensors):
    """{name: torch tensor} → {name: jax array of the same dtype} (exact)."""
    return {k: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == BF16
                                                      else jnp.float32)
            for k, t in tensors.items()}


def assert_matches(state, losses, ref, tol, n_steps):
    """The port's state and losses against a JAX reference (params, mu,
    nu, count, losses): bf16 moments by the ulp contract in strict mode."""
    params, mu, nu, count, ref_losses = ref
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref_losses), *tol["loss"])
    assert state.count == int(count) == n_steps
    ref_params = named(params)
    assert set(state.params) == set(ref_params)
    for name, val in state.params.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(ref_params[name]), *tol["params"],
                                   err_msg=f"params {name}")
    got = SimpleNamespace(mu=as_jax(state.m), nu=as_jax(state.v))
    want = SimpleNamespace(mu=named(mu), nu=named(nu))
    assert any(v.dtype == jnp.bfloat16 for v in want.mu.values())
    assert_adam_moments(got, want, mu_rtol=tol["mu"][0], mu_atol=tol["mu"][1],
                        nu_rtol=tol["nu"][0], nu_atol=tol["nu"][1])


def xla_ref(model, tx, jstate, noise):
    params, opt, losses = run_xla_steps(model, tx, jstate, *map(jnp.asarray, noise))
    adam = jax_k1._adam_state(opt)
    return params, adam.mu, adam.nu, adam.count, losses


def assert_moment_dtypes(state):
    for tree in (state.m, state.v):
        for name, t in tree.items():
            want = BF16 if t.dim() >= 2 else F32
            assert t.dtype == want, (name, t.dtype)
            assert state.params[name].dtype == F32


# --- the rule and the state ------------------------------------------------------

def test_moment_dtype_rule():
    assert moment_dtype((12, 20), "bf16") == BF16
    assert moment_dtype((200, 200), "bf16") == BF16
    for shape in ((20,), (1,), ()):
        assert moment_dtype(shape, "bf16") == F32
    assert moment_dtype((12, 20), "f32") == F32
    with pytest.raises(ValueError, match="adam_dtype must be f32\\|bf16"):
        moment_dtype((2, 2), "fp16")
    assert k1.moments_bf16("bf16") and not k1.moments_bf16("f32")
    # the kernels' matrix slots: We, Wd, Ws; every W of every MLP stack
    layout = k1.param_layout(4, 3, dual=True)
    mask = k1.matrix_mask(layout).tolist()
    assert mask == [True] * 12 + [False] * 3 + [True] * 12 + [False] * (4 + 3 + 1) + \
        [True] * 12 + [False] * 4
    enc, dec = (4, 5, 3), (3, 5, 4)
    mask = k1.matrix_mask(k5.param_layout(enc, dec))
    assert int(mask.sum()) == 4 * 5 + 5 * 3 + 3 * 5 + 5 * 4


def test_bf16_moment_dtypes_after_create_chunk_and_checkpoint(tmp_path):
    ds = LinearGaussianDataset.create(2, 3, 3, 9)
    model = build_vae(data_dim=12, latent_dim=20, epsilon=-1.0, tunable_decoder_var=True)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 7, 8, adam_dtype="bf16")
    assert_moment_dtypes(state)
    assert state.adam_dtype == "bf16"
    assert TrainState.create(dict(model.named_parameters()), 7, 8).adam_dtype == "f32"
    # the torch path, and K1's plain version through its Trainer chunk
    state, _ = train_chunk(model, ds, state, 3, batch_size=BATCH, lr=1e-3)
    assert_moment_dtypes(state)
    cfg = parse_arguments(["k", *ROW1, "--adam_dtype", "bf16"])
    state, _ = k1.make_train_chunk(model, ds, cfg)(state, 3)
    assert_moment_dtypes(state)
    assert state.count == 6 and float(state.m["Encoder.FC0.kernel"].abs().sum()) > 0
    # torch.save keeps the dtypes and the bits; the meta names the mode
    ck.save_checkpoint(str(tmp_path), state)
    back = ck.restore_checkpoint(str(tmp_path))
    assert_moment_dtypes(back)
    for a, b in ((state.m, back.m), (state.v, back.v), (state.params, back.params)):
        for name in a:
            assert torch.equal(a[name].view(torch.int16) if a[name].dtype == BF16 else a[name],
                               b[name].view(torch.int16) if b[name].dtype == BF16 else b[name])
    assert ck.read_checkpoint_meta(str(tmp_path))["adam_dtype"] == "bf16"


def test_f32_default_is_bitwise_unchanged():
    """The f32 mode runs the update it ran before bf16 moments existed:
    the in-place optax.adam step, written out here, bit for bit."""
    ds = LinearGaussianDataset.create(2, 3, 3, 9)
    model = build_vae(data_dim=12, latent_dim=20, epsilon=-1.0, tunable_decoder_var=True)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 7, 8)
    assert all(t.dtype == F32 for t in (*state.m.values(), *state.v.values()))
    ref = TrainState.create(dict(model.named_parameters()), 7, 8)
    state, losses = train_chunk(model, ds, state, 4, batch_size=BATCH, lr=1e-3)
    names = list(ref.params)
    params = {k: ref.params[k].clone().requires_grad_(True) for k in names}
    from vae_training_tpu_torch.train.step import loss_terms, sample_z

    for i in range(4):
        x = ds.sample(7, i, BATCH)
        z1, z2 = sample_z(8, i, BATCH, 20, 12)
        loss = loss_terms(model, params, x, z1, z2)[0]
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        with torch.no_grad():
            for k, g in zip(names, grads):
                m, v, p = ref.m[k], ref.v[k], params[k]
                m.mul_(0.9).add_(g, alpha=1.0 - 0.9)
                v.mul_(0.999).addcmul_(g, g, value=1.0 - 0.999)
                p.sub_(1e-3 * ((m / (1.0 - 0.9 ** (i + 1)))
                               / (torch.sqrt(v / (1.0 - 0.999 ** (i + 1))) + 1e-8)))
        assert torch.equal(losses[i], loss.detach())
    for k in names:
        assert torch.equal(state.params[k], params[k].detach())
        assert torch.equal(state.m[k], ref.m[k]) and torch.equal(state.v[k], ref.v[k])


# --- K1, K2: the plain versions and the torch path against JAX ------------------

def run_pallas_linear(kind, jstate, noise, tdv, D, L, dd):
    n = noise[0].shape[0]
    xp, z1p, z2p = pad_noise(*noise, n, batch=BATCH, lane=jax_k1.N)
    dual = kind == "sigmoid"
    bufs = jax_k1.pack_state(jstate, D, L, tdv, dual=dual)
    new_bufs, losses = jax_k1.run_fused_chunk(
        n_steps=n, seed_and_t0=jnp.array([123, 0], jnp.int32),
        a_t=jnp.zeros((jax_k1.N, jax_k1.N), jnp.float32), buffers=bufs, batch=BATCH,
        data_dim=D, latent_dim=L, intrinsic_dim=dd, var_added=0.0, eps_const=-1.0, tdv=tdv,
        lr=1e-3, dataset_kind=kind, dual=dual, external_noise=(xp, z1p, z2p),
        interpret=True)
    kstate = jax_k1.unpack_state(jstate, new_bufs, n, D, L, tdv, dual=dual)
    adam = jax_k1._adam_state(kstate.opt_state)
    return kstate.params, adam.mu, adam.nu, adam.count, losses


LIN_DIMS = {"linear": (3, 9, 20), "sigmoid": (3, 8, 20)}  # (dd, pad, L): D 12, L 20


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["linear", "sigmoid"], ids=["K1", "K2"])
@pytest.mark.parametrize("tdv", [True, False])
def test_plain_k1_k2_bf16_match_jax(reference, kind, tdv):
    n, (dd, pad, L) = 5, LIN_DIMS[kind]
    ds, model, tx, jstate = jax_case(kind, tdv, dims=LIN_DIMS[kind])
    D, dual = ds.dimension, kind == "sigmoid"
    noise = jax_noise(ds, kind, n, L)
    state = port_state(jstate)
    assert_moment_dtypes(state)
    p, m, v = k1.pack_state(state, D, L, dual)
    losses = k1.run_fused_chunk(
        p, m, v, torch.tensor(np.asarray(ds.A)), n_steps=n, batch=BATCH, data_dim=D,
        latent_dim=L, intrinsic_dim=dd, manifold_dim=dd, step0=0, t0=0, data_seed=1,
        model_seed=2, var_added=0.0, eps_const=-1.0, tdv=tdv, lr=1e-3, dual=dual,
        external_noise=tuple(map(torch.as_tensor, noise)), adam_dtype="bf16")
    mask = k1.matrix_mask(k1.param_layout(D, L, dual))
    for flat in (m, v):  # the kernel's buffers hold bf16 values in the matrix slots
        assert torch.equal(flat[mask], flat[mask].bfloat16().float())
    state = k1.unpack_state(state, p, m, v, n, D, L, dual)
    assert_moment_dtypes(state)
    ref = (xla_ref(model, tx, jstate, noise) if reference == "xla"
           else run_pallas_linear(kind, jstate, noise, tdv, D, L, dd))
    assert_matches(state, losses.numpy(), ref, LIN_TOL, n)


@pytest.mark.parametrize("kind,hidden", [("linear", ""), ("sigmoid", ""), ("sphere", "16|16")],
                         ids=["linear", "sigmoid", "sphere-MLP"])
def test_torch_path_bf16_matches_jax_xla(kind, hidden):
    n = 5 if not hidden else 4
    dims = LIN_DIMS.get(kind, (3, 5, 6))
    ds, model, tx, jstate = jax_case(kind, True, hidden=hidden, dims=dims)
    L = dims[2]
    noise = jax_noise(ds, kind, n, L)
    port = build_vae(data_dim=ds.dimension, latent_dim=L, encoder_layer_sizes=hidden,
                     decoder_layer_sizes=hidden, epsilon=-1.0 if not hidden else -3.0,
                     tunable_decoder_var=True,
                     dataset_name="sigmoid" if kind == "sigmoid" else None)
    state, losses = train_chunk(port, None, port_state(jstate), n, batch_size=BATCH, lr=1e-3,
                                noise=tuple(map(torch.as_tensor, noise)))
    assert_moment_dtypes(state)
    assert_matches(state, losses.numpy(), xla_ref(model, tx, jstate, noise),
                   MLP_TOL if hidden else LIN_TOL, n)


# --- K5, K5-dual: the plain versions against JAX ----------------------------------

def run_pallas_mlp(kind, model, jstate, noise, D, L, dd):
    n = noise[0].shape[0]
    dual = kind == "sigmoid"
    enc_dims = jax_k5._layer_dims(model.encoder_features, D)
    dec_dims = jax_k5._layer_dims(model.decoder_features, L)
    packed = jax_k5.pack_mlp_state(jstate, enc_dims, dec_dims, True, dual=dual)
    new_packed, losses = jax_k5.run_mlp_fused_chunk(
        n_steps=n, seed_and_t0=jnp.array([7, 0], jnp.int32),
        a_t=jnp.zeros((jax_k5.LANE, jax_k5.LANE), jnp.float32), packed=packed, batch=BATCH,
        data_dim=D, latent_dim=L, enc_dims=enc_dims, dec_dims=dec_dims, dataset_kind=kind,
        intrinsic_dim=dd, var_added=0.0, eps_const=-3.0, tdv=True, lr=1e-3,
        external_noise=pad_noise(*noise, n, batch=BATCH, lane=jax_k5.LANE), interpret=True,
        dual=dual)
    kstate = jax_k5.unpack_mlp_state(jstate, new_packed, n, enc_dims, dec_dims, True, L,
                                     dual=dual)
    adam = jax_k1._adam_state(kstate.opt_state)
    return kstate.params, adam.mu, adam.nu, adam.count, losses


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["sphere", "sigmoid"], ids=["K5", "K5-dual"])
def test_plain_k5_bf16_matches_jax(reference, kind):
    n, dims = 4, ((3, 5, 6) if kind == "sphere" else (3, 4, 6))
    ds, model, tx, jstate = jax_case(kind, True, hidden="16|16", dims=dims)
    D, L, dd = ds.dimension, dims[2], dims[0]
    noise = jax_noise(ds, kind, n, L)
    state = port_state(jstate)
    enc, dec = (D, 16, 16, L), (L, 16, 16, D)
    dual = kind == "sigmoid"
    p, m, v = k5.pack_state(state, enc, dec, dual)
    losses = k5.run_mlp_fused_chunk(
        p, m, v, torch.tensor(np.asarray(ds.A)) if dual else None, n_steps=n, batch=BATCH,
        enc_widths=enc, dec_widths=dec, kind=kind, intrinsic_dim=dd, manifold_dim=dd,
        step0=0, t0=0, data_seed=1, model_seed=2, var_added=0.0, eps_const=-3.0, tdv=True,
        lr=1e-3, external_noise=tuple(map(torch.as_tensor, noise)), dual=dual,
        adam_dtype="bf16")
    state = k5.unpack_state(state, p, m, v, n, enc, dec, dual)
    assert_moment_dtypes(state)
    assert any(name.startswith("SigDecoder") for name in state.m) == dual
    ref = (xla_ref(model, tx, jstate, noise) if reference == "xla"
           else run_pallas_mlp(kind, model, jstate, noise, D, L, dd))
    assert_matches(state, losses.numpy(), ref, MLP_TOL, n)


# --- K6a, K6b: 3-row plain grids against the JAX XLA path, row by row ------------

@pytest.mark.parametrize("kind,hidden,rows", [
    ("linear", "", [(3, 9, 20), (4, 2, 10), (6, 6, 12)]),
    ("sigmoid", "", [(3, 8, 20), (3, 3, 6), (5, 5, 10)]),
    ("sphere", "16|16", [(3, 3, 6), (5, 8, 10), (3, 13, 8)]),
], ids=["K6a-linear", "K6a-sigmoid", "K6b-sphere"])
def test_plain_grid_bf16_rows_match_jax_xla(kind, hidden, rows):
    n, dual, mlp = 4, kind == "sigmoid", bool(hidden)
    cases = [jax_case(kind, True, hidden=hidden, seed=i, dims=spec)
             for i, spec in enumerate(rows)]
    noises = [jax_noise(ds, kind, n, spec[2], seed=10 + i)
              for i, ((ds, *_), spec) in enumerate(zip(cases, rows))]
    states = [port_state(js) for *_, js in cases]
    grows = [k1.GridRow(ds.dimension, spec[2], ds.intrinsic_dim if kind == "linear" else ds.dim,
                        ds.dim,
                        None if kind == "sphere" else torch.tensor(np.asarray(ds.A)),
                        step0=0, t0=0, data_seed=1, model_seed=2)
             for (ds, *_), spec in zip(cases, rows)]
    ext = [tuple(map(torch.as_tensor, nz)) for nz in noises]
    kw = dict(n_steps=n, batch=BATCH, eps_const=-3.0 if mlp else -1.0, tdv=True, lr=1e-3,
              dual=dual, external_noise=ext, adam_dtype="bf16")
    if mlp:
        hid = (16, 16)
        p, m, v = k5.pack_rows(states, grows, hid, hid, dual)
        calls = k5.plain_grid_chunk.calls
        losses = k5.run_grid_chunk(p, m, v, grows, enc_hidden=hid, dec_hidden=hid, kind=kind,
                                   **kw)
        assert k5.plain_grid_chunk.calls == calls + 1
        states = k5.unpack_rows(states, p, m, v, grows, n, hid, hid, dual)
    else:
        p, m, v = k1.pack_rows(states, grows, dual)
        calls = k1.plain_grid_chunk.calls
        losses = k1.run_grid_chunk(p, m, v, grows, **kw)
        assert k1.plain_grid_chunk.calls == calls + 1
        states = k1.unpack_rows(states, p, m, v, grows, n, dual)
    for i, ((_, model, tx, jstate), state) in enumerate(zip(cases, states)):
        assert_moment_dtypes(state)
        assert_matches(state, losses[i].numpy(), xla_ref(model, tx, jstate, noises[i]),
                       MLP_TOL if mlp else LIN_TOL, n)


# --- grid uniformity: rows that mix adam_dtype share no launch ----------------

def _cfg(**kw):
    base = dict(batch_size=100, adam_dtype="f32", device="cuda", kernels="auto", nojit=False,
                learning_rate=1e-3, num_batches=100, n_print=50, n_plot=100)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture
def fake_h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))


@pytest.mark.parametrize("kernel", ["K6a", "K6b"])
def test_grid_supported_refuses_rows_that_mix_adam_dtype(fake_h100, kernel):
    if kernel == "K6a":
        ds = [LinearGaussianDataset.create(s, 3, 3, 9) for s in (2, 3)]
        models = [build_vae(data_dim=12, latent_dim=20, epsilon=-1.0,
                            tunable_decoder_var=True)] * 2
        module = k1
    else:
        ds = [SphereDataset(3, 3)] * 2
        models = [build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes="32|32",
                            decoder_layer_sizes="32|32", epsilon=-3.0,
                            tunable_decoder_var=True)] * 2
        module = k5
    for dtype in ("f32", "bf16"):
        ok, why = module.grid_supported(models, ds, _cfg(adam_dtype=dtype))
        assert ok, why
    ok, why = module.grid_supported(models, ds, [_cfg(), _cfg(adam_dtype="bf16")])
    assert not ok
    assert "row 1 differs from row 0 in adam_dtype ('bf16' vs 'f32')" in why


def test_dispatch_lines_name_bf16_moments(fake_h100, capsys):
    lin = build_vae(data_dim=12, latent_dim=20, epsilon=-1.0, tunable_decoder_var=True)
    ds = LinearGaussianDataset.create(2, 3, 3, 9)
    dispatch.make_train_chunk(lin, ds, _cfg(adam_dtype="bf16", kernels="cuda"))
    out = capsys.readouterr().out
    assert re.search(r"^\[kernels\] cuda: fused linear-VAE kernel K1 \(.*\) with bf16 Adam "
                     r"moments$", out, re.M), out
    sph = build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes="32", decoder_layer_sizes="32",
                    epsilon=-3.0, tunable_decoder_var=True)
    dispatch.make_train_chunk(sph, SphereDataset(3, 3), _cfg(adam_dtype="bf16"))
    assert "fused MLP-VAE kernel K5 (" in capsys.readouterr().out
    dispatch.make_grid_chunk([sph] * 2, [SphereDataset(3, 3)] * 2, _cfg(adam_dtype="bf16"))
    out = capsys.readouterr().out
    assert "[kernels] cuda: K6b" in out and out.rstrip().endswith("with bf16 Adam moments")
    dispatch.make_train_chunk(lin, ds, _cfg(adam_dtype="f32", kernels="torch"))
    assert "bf16" not in capsys.readouterr().out


# --- the CLI: resume, the seed grid, the converter, model.pkl ---------------------

def run(name, data_dir, *extra, num_batches=20):
    return cli([name, *ROW1, "--num_batches", str(num_batches), "--data_dir", str(data_dir),
                *extra])


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def assert_same_run(dir_a, dir_b):
    """losses.npz and the whole model.pkl (params and moments) bitwise."""
    za, zb = np.load(os.path.join(dir_a, "losses.npz")), np.load(os.path.join(dir_b, "losses.npz"))
    assert set(za.files) == set(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with open(os.path.join(dir_a, "model.pkl"), "rb") as f:
        pa = pickle.load(f)
    with open(os.path.join(dir_b, "model.pkl"), "rb") as f:
        pb = pickle.load(f)
    la, lb = list(_leaves(pa)), list(_leaves(pb))
    assert len(la) == len(lb) and pa["state"]["step"] == pb["state"]["step"]
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_bf16_resume_is_bitwise(tmp_path):
    """10 + 10 steps equal 20 steps, in bf16: the checkpoint keeps the
    moments' dtype and bits."""
    assert run("full", tmp_path, "--adam_dtype", "bf16") == 0
    assert run("part", tmp_path, "--adam_dtype", "bf16", num_batches=10) == 0
    state = ck.restore_checkpoint(str(tmp_path / "part"))
    assert_moment_dtypes(state)
    assert ck.read_checkpoint_meta(str(tmp_path / "part"))["adam_dtype"] == "bf16"
    assert run("resumed", tmp_path, "--adam_dtype", "bf16", "--resume",
               str(tmp_path / "part")) == 0
    assert_same_run(tmp_path / "full", tmp_path / "resumed")
    assert_moment_dtypes(ck.restore_checkpoint(str(tmp_path / "resumed")))
    # the f32 run of the same row is another run
    assert run("f32", tmp_path) == 0
    a = np.load(tmp_path / "f32" / "losses.npz")["VAE Loss"]
    b = np.load(tmp_path / "full" / "losses.npz")["VAE Loss"]
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("saved,resumed", [("f32", "bf16"), ("bf16", "f32")])
def test_resume_with_the_other_adam_dtype_raises(tmp_path, saved, resumed):
    assert run("part", tmp_path, "--adam_dtype", saved, num_batches=4) == 0
    with pytest.raises(ValueError, match=f"this run's --adam_dtype is {resumed}; "
                                         "--adam_dtype must match across --resume"):
        run("resumed", tmp_path, "--adam_dtype", resumed, "--resume", str(tmp_path / "part"))
    # the seed grid's resume checks every row
    assert run("g", tmp_path, "--adam_dtype", saved, "--seed_grid", "2,3", num_batches=4) == 0
    with pytest.raises(ValueError, match="--adam_dtype must match across --resume"):
        run("g", tmp_path, "--adam_dtype", resumed, "--seed_grid", "2,3", "--resume", "rows",
            num_batches=6)


def test_bf16_seed_grid_rows_equal_solo_runs_bitwise(tmp_path, capsys):
    calls = k1.plain_grid_chunk.calls
    assert run("grid", tmp_path, "--adam_dtype", "bf16", "--seed_grid", "2,3") == 0
    out = capsys.readouterr().out
    assert k1.plain_grid_chunk.calls > calls
    assert re.search(r"^\[kernels\] plain: K6a's plain version on the CPU, 2 rows a chunk.* "
                     r"with bf16 Adam moments$", out, re.M)
    for seed in (2, 3):
        assert run(f"solo{seed}", tmp_path, "--adam_dtype", "bf16", "-ds", str(seed)) == 0
        assert_same_run(tmp_path / f"solo{seed}", tmp_path / f"grid_seed{seed}")
        assert_moment_dtypes(ck.restore_checkpoint(str(tmp_path / f"grid_seed{seed}")))


def test_state_from_flax_keeps_jax_bf16_moments_bitwise():
    ds, model, tx, jstate = jax_case("linear", True)
    noise = jax_noise(ds, "linear", 3, 20)
    params, opt, _ = run_xla_steps(model, tx, jstate, *map(jnp.asarray, noise))
    adam = jax_k1._adam_state(opt)
    state = export.state_from_flax(jax.device_get(params), jax.device_get(adam.mu),
                                   jax.device_get(adam.nu), int(adam.count))
    assert_moment_dtypes(state)
    for tree, ref in ((state.m, named(adam.mu)), (state.v, named(adam.nu)),
                      (state.params, named(params))):
        for name, t in tree.items():
            want = np.asarray(jax.device_get(ref[name]))
            if t.dtype == BF16:
                assert want.dtype.name == "bfloat16"
                np.testing.assert_array_equal(t.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), want)


def test_bf16_model_pkl_round_trips(tmp_path):
    """A bf16 run's model.pkl holds its moments as float32 arrays of the
    same values (no ml_dtypes on the port's side); load_model_pkl gives
    them back, and --state_dict into a bf16 run rounds them once (exact)."""
    assert run("r", tmp_path, "--adam_dtype", "bf16", num_batches=6) == 0
    state = ck.restore_checkpoint(str(tmp_path / "r"))
    with open(tmp_path / "r" / "model.pkl", "rb") as f:
        sd = pickle.load(f)
    assert all(np.asarray(a).dtype == np.float32 for a in _leaves(sd["state"]["param_states"]))
    loaded = export.load_model_pkl(str(tmp_path / "r" / "model.pkl"))
    assert loaded.count == state.count == 6
    for a, b in ((loaded.params, state.params), (loaded.m, state.m), (loaded.v, state.v)):
        assert set(a) == set(b)
        for name in b:
            assert a[name].dtype == F32
            assert torch.equal(a[name], b[name].float()), name
    cfg = parse_arguments(["s", *ROW1, "--adam_dtype", "bf16", "--state_dict",
                           str(tmp_path / "r" / "model.pkl")])
    trainer = Trainer(cfg, LinearGaussianDataset.create(2, 3, 3, 9), str(tmp_path))
    assert_moment_dtypes(trainer.state)
    for a, b in ((trainer.state.m, state.m), (trainer.state.v, state.v)):
        for name in b:
            assert torch.equal(a[name].float(), b[name].float()), name
    assert trainer.state.count == 6

