"""K2's plain version against both JAX references, and K2's host-side code.

K2 is the sigmoid dataset's dual-decoder branch of the fused linear kernel
(``vae_training_tpu_torch/csrc/linear_vae.cu``, ``dual=True``). The same
initial parameters (the JAX package's flax init, SigDecoder included,
carried across with ``state_from_flax``) and the same numpy-drawn
(x, z1, z2) streams go through

  - the port's ``run_fused_chunk(..., dual=True)`` on CPU tensors, i.e. its
    plain version (torch autograd + the explicit Adam update), and
  - the JAX package's jax.grad + optax reference (``run_xla_steps``) and its
    Pallas kernel in interpret mode with external noise
    (``dataset_kind="sigmoid", dual=True``),

and must agree at ``tests/test_pallas_kernel.py``'s tolerances: losses
rtol/atol 2e-4, params rtol 5e-4 / atol 5e-5, Adam m rtol 5e-4 / atol 1e-6,
v rtol 5e-4 / atol 1e-7 (both sides are fp32; only summation order and
libm ulps differ). The CUDA kernel itself is held against this plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_test_helpers import pad_noise, run_xla_steps  # noqa: E402
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

BATCH = 32
LATENT = 20
DIM = 3
PAD = 8
D = DIM + 1 + PAD
N_STEPS = 5
TOL = dict(loss=(2e-4, 2e-4), params=(5e-4, 5e-5), mu=(5e-4, 1e-6), nu=(5e-4, 1e-7))


def flat(tree):
    """Nested flax tree → {dotted name: numpy}."""
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_setup(tdv):
    dataset = JaxSigmoid.create(2, dimension=DIM, padding_dimension=PAD)
    model = jax_build_vae(data_dim=D, latent_dim=LATENT, encoder_layer_sizes="",
                          decoder_layer_sizes="", epsilon=-1.0,
                          tunable_decoder_var=tdv, dataset_name="sigmoid")
    tx = make_adam(1e-3)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, D)),
                        jnp.zeros((1, LATENT)), jnp.zeros((1, D)))["params"]
    state = JaxTrainState.create(params=params, tx=tx,
                                 model_key=jax.random.PRNGKey(1),
                                 data_key=jax.random.PRNGKey(2))
    return dataset, model, tx, state


def noise(dataset, seed=0):
    rs = np.random.RandomState(seed)
    z = rs.randn(N_STEPS, BATCH, DIM).astype(np.float32)
    sig = 1 / (1 + np.exp(-(z @ np.asarray(dataset.A))))
    xs = np.concatenate([z, sig, np.zeros((N_STEPS, BATCH, PAD), np.float32)], axis=-1)
    z1s = rs.randn(N_STEPS, BATCH, LATENT).astype(np.float32)
    z2s = rs.randn(N_STEPS, BATCH, D).astype(np.float32)
    return xs.astype(np.float32), z1s, z2s


def port_state(jstate):
    adam = jax_k1._adam_state(jstate.opt_state)
    return state_from_flax(jax.device_get(jstate.params), jax.device_get(adam.mu),
                           jax.device_get(adam.nu), int(adam.count))


def run_port(dataset, jstate, xs, z1s, z2s, tdv):
    state = port_state(jstate)
    p, m, v = k1.pack_state(state, D, LATENT, dual=True)
    losses = k1.run_fused_chunk(
        p, m, v, torch.tensor(np.asarray(dataset.A)), n_steps=N_STEPS,
        batch=BATCH, data_dim=D, latent_dim=LATENT, intrinsic_dim=DIM,
        manifold_dim=DIM, step0=0, t0=state.count, data_seed=1, model_seed=2,
        var_added=0.0, eps_const=-1.0, tdv=tdv, lr=1e-3, dual=True,
        external_noise=tuple(torch.as_tensor(a) for a in (xs, z1s, z2s)))
    state = k1.unpack_state(state, p, m, v, N_STEPS, D, LATENT, dual=True)
    return state, losses.numpy()


def run_pallas(jstate, xs, z1s, z2s, tdv):
    xp, z1p, z2p = pad_noise(xs, z1s, z2s, N_STEPS, batch=BATCH, lane=jax_k1.N)
    bufs = jax_k1.pack_state(jstate, D, LATENT, tdv, dual=True)
    new_bufs, losses = jax_k1.run_fused_chunk(
        n_steps=N_STEPS, seed_and_t0=jnp.array([123, 0], jnp.int32),
        a_t=jnp.zeros((jax_k1.N, jax_k1.N), jnp.float32), buffers=bufs,
        batch=BATCH, data_dim=D, latent_dim=LATENT, intrinsic_dim=DIM,
        var_added=0.0, eps_const=-1.0, tdv=tdv, lr=1e-3, dataset_kind="sigmoid",
        dual=True, external_noise=(xp, z1p, z2p), interpret=True)
    kstate = jax_k1.unpack_state(jstate, new_bufs, N_STEPS, D, LATENT, tdv, dual=True)
    adam = jax_k1._adam_state(kstate.opt_state)
    return kstate.params, adam.mu, adam.nu, int(adam.count), np.asarray(losses)


def run_xla(model, tx, jstate, xs, z1s, z2s):
    params, opt, losses = run_xla_steps(model, tx, jstate, jnp.asarray(xs),
                                        jnp.asarray(z1s), jnp.asarray(z2s))
    adam = jax_k1._adam_state(opt)
    return params, adam.mu, adam.nu, int(adam.count), losses


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("tdv", [True, False])
def test_plain_k2_matches_jax(reference, tdv):
    dataset, model, tx, jstate = jax_setup(tdv)
    xs, z1s, z2s = noise(dataset)
    state, losses = run_port(dataset, jstate, xs, z1s, z2s, tdv)
    if reference == "xla":
        params, mu, nu, count, ref_losses = run_xla(model, tx, jstate, xs, z1s, z2s)
    else:
        params, mu, nu, count, ref_losses = run_pallas(jstate, xs, z1s, z2s, tdv)
    np.testing.assert_allclose(losses, ref_losses, *TOL["loss"])
    assert state.count == count == N_STEPS and state.step == N_STEPS
    for got, ref, tol in ((state.params, params, "params"), (state.m, mu, "mu"),
                          (state.v, nu, "nu")):
        ref = flat(ref)
        assert set(got) == set(ref)
        assert "SigDecoder.FC0.kernel" in got
        for name, val in got.items():
            np.testing.assert_allclose(val.numpy(), ref[name], *TOL[tol],
                                       err_msg=f"{tol} {name}")


def test_dual_model_forward_matches_flax():
    """The port's dual decoder σ(SigDecoder(s)) + Decoder(s) on the flax
    parameters gives the flax model's outputs, training and sampling mode."""
    dataset, model, _, jstate = jax_setup(True)
    state = port_state(jstate)
    port = build_vae(data_dim=D, latent_dim=LATENT, epsilon=-1.0,
                     tunable_decoder_var=True, dataset_name="sigmoid")
    assert set(dict(port.named_parameters())) == set(state.params)
    rs = np.random.RandomState(7)
    x, z1, z2 = (rs.randn(BATCH, n).astype(np.float32) for n in (D, LATENT, D))
    ref = model.apply({"params": jstate.params}, x, z1, z2)
    got = torch.func.functional_call(port, state.params, tuple(map(torch.as_tensor, (x, z1, z2))))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    fake = model.apply({"params": jstate.params}, z1, z2, jnp.float32(-0.5),
                       method=type(model).generate)
    got = torch.func.functional_call(port, state.params, (None, torch.as_tensor(z1),
                                                          torch.as_tensor(z2), torch.tensor(-0.5)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(fake), rtol=1e-5, atol=1e-5)


def test_init_parameters_draws_the_sig_decoder():
    model = build_vae(data_dim=D, latent_dim=LATENT, dataset_name="sigmoid")
    model.init_parameters(3)
    ws = dict(model.named_parameters())["SigDecoder.FC0.kernel"]
    wd = dict(model.named_parameters())["Decoder.FC0.kernel"]
    assert ws.shape == wd.shape == (LATENT, D)
    assert not torch.equal(ws, wd)
    # lecun-normal scale: std sqrt(1/fan_in) within sampling error
    assert abs(ws.std().item() - (1 / LATENT) ** 0.5) < 0.05
    model2 = build_vae(data_dim=D, latent_dim=LATENT, dataset_name="sigmoid")
    model2.init_parameters(3)
    assert torch.equal(dict(model2.named_parameters())["SigDecoder.FC0.kernel"], ws)


def test_dual_pack_unpack_round_trip():
    rs = np.random.RandomState(3)
    layout = k1.param_layout(D, LATENT, dual=True)
    # the dual layout is K1's followed by the SigDecoder: K1's buffers unchanged
    assert layout[:6] == k1.param_layout(D, LATENT)
    assert [n for n, _ in layout[6:]] == ["SigDecoder.FC0.kernel", "SigDecoder.FC0.bias"]
    tensors = {n: torch.as_tensor(rs.randn(*s).astype(np.float32)) for n, s in layout}
    buf = k1.pack(tensors, D, LATENT, dual=True)
    assert buf.shape == (k1.n_params(D, LATENT, dual=True),)
    assert torch.equal(buf[:k1.n_params(D, LATENT)], k1.pack(tensors, D, LATENT))
    out = {n: torch.zeros_like(t) for n, t in tensors.items()}
    k1.unpack_(buf, out, D, LATENT, dual=True)
    for n in tensors:
        assert torch.equal(out[n], tensors[n])


def _cfg(**kw):
    base = dict(batch_size=100, adam_dtype="f32", device="cuda", kernels="auto", nojit=False,
                learning_rate=1e-4)
    base.update(kw)
    return SimpleNamespace(**base)


def test_k2_gating(monkeypatch):
    sig = SigmoidDataset.create(69, 3, 3)
    dual = build_vae(data_dim=7, latent_dim=6, epsilon=-3.0, tunable_decoder_var=True,
                     dataset_name="sigmoid")
    plain = build_vae(data_dim=7, latent_dim=6, epsilon=-3.0)
    ok, why = k1.supported(dual, sig, _cfg(device="cpu"))
    assert not ok and "not a CUDA device" in why
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    ok, why = k1.supported(dual, sig, _cfg())
    assert ok and "dual-decoder VAE on sigmoid" in why
    ok, why = k1.supported(plain, sig, _cfg())
    assert not ok and "expects the dual decoder" in why
    lin = LinearGaussianDataset.create(2, 3, 3, 4)
    ok, why = k1.supported(dual, lin, _cfg())
    assert not ok and "needs the sigmoid dataset" in why
    ok, why = k1.supported(plain, SphereDataset(3, 3), _cfg())
    assert not ok and "linear_gaussian and sigmoid" in why
    mlp = build_vae(data_dim=7, latent_dim=6, encoder_layer_sizes="16",
                    decoder_layer_sizes="16", dataset_name="sigmoid")
    ok, why = k1.supported(mlp, sig, _cfg())
    assert not ok and "0-hidden-layer" in why
    ok, why = k1.supported(dual, sig, _cfg(batch_size=4096))
    assert not ok and "shared memory" in why


@pytest.mark.parametrize("dd,pd,ld", [(3, 3, 6), (3, 13, 8), (5, 16, 16), (5, 5, 10),
                                      (7, 7, 13), (7, 20, 24)])
def test_every_sigmoid_sweep_row_fits_shared_memory(dd, pd, ld):
    # the rows of sigmoid_vae_padding_expts.sh at batch 100 (ambient dd + 1 + pd)
    assert k1.smem_bytes(100, dd + 1 + pd, ld, dd, dd, dual=True) <= k1.SMEM_LIMIT
