"""K5-dual's plain version against both JAX references, and its host-side code.

K5-dual is the sigmoid dual-decoder branch of the fused MLP-VAE kernel
(``vae_training_tpu_torch/csrc/mlp_vae.cu``, ``dual``): MLPs on the sigmoid
dataset, x̂ = σ(SigDecoder(s)) + Decoder(s) with the SigDecoder mirroring the
decoder's widths. The same initial parameters (the JAX package's flax init
of ``HIDDEN`` ReLU stacks, carried across with ``state_from_flax``) and the
same numpy-drawn (x, z1, z2) streams go through

  - the port's ``run_mlp_fused_chunk(dual=True)`` on CPU tensors, i.e. its
    plain version (torch autograd + the explicit Adam update), and
  - the JAX package's jax.grad + optax reference (``run_xla_steps``) and its
    Pallas MLP kernel with ``dual=True`` in interpret mode with external
    noise (the call tests/test_mlp_kernel.py:126-165 makes),

and must agree at ``tests/test_mlp_kernel.py``'s tolerances: losses
rtol/atol 3e-4, params rtol 1e-3 / atol 1e-5, Adam m rtol 1e-3 / atol 1e-6,
v rtol 1e-3 / atol 1e-9 (both sides are fp32; the stacks' sums are taken in
other orders). The CUDA kernel itself is held against this plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 19).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_test_helpers import pad_noise, run_xla_steps  # noqa: E402
from vae_training_tpu.data import SigmoidDataset as JaxSigmoid  # noqa: E402
from vae_training_tpu.kernels import mlp_vae as jax_k5  # noqa: E402
from vae_training_tpu.kernels.linear_vae import _adam_state  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu_torch.data import SigmoidDataset, SphereDataset  # noqa: E402
from vae_training_tpu_torch.kernels import dispatch  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.kernels import mlp_vae as k5  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.runio.export import state_from_flax  # noqa: E402
from vae_training_tpu_torch.train import TrainState  # noqa: E402

BATCH = 32
LATENT = 6
HIDDEN = "16|16"
DIM, PAD = 3, 4  # ambient D = 3 + 1 + 4
N_STEPS = 4
TOL = dict(loss=(3e-4, 3e-4), params=(1e-3, 1e-5), mu=(1e-3, 1e-6), nu=(1e-3, 1e-9))


def flat(tree):
    """Nested flax tree → {dotted name: numpy}."""
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_setup(tdv):
    dataset = JaxSigmoid.create(2, dimension=DIM, padding_dimension=PAD)
    D = dataset.dimension
    model = jax_build_vae(data_dim=D, latent_dim=LATENT, encoder_layer_sizes=HIDDEN,
                          decoder_layer_sizes=HIDDEN, epsilon=-3.0, tunable_decoder_var=tdv,
                          dataset_name="sigmoid")
    tx = make_adam(1e-3)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, D)), jnp.zeros((1, LATENT)),
                        jnp.zeros((1, D)))["params"]
    state = JaxTrainState.create(params=params, tx=tx, model_key=jax.random.PRNGKey(1),
                                 data_key=jax.random.PRNGKey(2))
    return dataset, model, tx, state


def noise(dataset, seed=11):
    """x on the sigmoid manifold [z, σ(z·a), 0], z1 and z2 standard normals."""
    rs = np.random.RandomState(seed)
    z = rs.randn(N_STEPS, BATCH, DIM).astype(np.float32)
    sig = 1 / (1 + np.exp(-(z @ np.asarray(dataset.A))))
    xs = np.concatenate([z, sig, np.zeros((N_STEPS, BATCH, PAD), np.float32)], axis=-1)
    z1s = rs.randn(N_STEPS, BATCH, LATENT).astype(np.float32)
    z2s = rs.randn(N_STEPS, BATCH, dataset.dimension).astype(np.float32)
    return xs.astype(np.float32), z1s, z2s


def widths(D):
    hidden = tuple(int(h) for h in HIDDEN.split("|"))
    return (D,) + hidden + (LATENT,), (LATENT,) + hidden + (D,)


def run_port(dataset, jstate, xs, z1s, z2s, tdv):
    adam = _adam_state(jstate.opt_state)
    state = state_from_flax(jax.device_get(jstate.params), jax.device_get(adam.mu),
                            jax.device_get(adam.nu), int(adam.count))
    enc, dec = widths(dataset.dimension)
    p, m, v = k5.pack_state(state, enc, dec, dual=True)
    losses = k5.run_mlp_fused_chunk(
        p, m, v, torch.tensor(np.asarray(dataset.A)), n_steps=N_STEPS, batch=BATCH,
        enc_widths=enc, dec_widths=dec, kind="sigmoid", intrinsic_dim=DIM, manifold_dim=DIM,
        step0=0, t0=state.count, data_seed=1, model_seed=2, var_added=0.0, eps_const=-3.0,
        tdv=tdv, lr=1e-3, external_noise=tuple(torch.as_tensor(a) for a in (xs, z1s, z2s)),
        dual=True)
    return k5.unpack_state(state, p, m, v, N_STEPS, enc, dec, dual=True), losses.numpy()


def run_pallas(dataset, model, jstate, xs, z1s, z2s, tdv):
    D = dataset.dimension
    enc_dims = jax_k5._layer_dims(model.encoder_features, D)
    dec_dims = jax_k5._layer_dims(model.decoder_features, LATENT)
    packed = jax_k5.pack_mlp_state(jstate, enc_dims, dec_dims, tdv, dual=True)
    new_packed, losses = jax_k5.run_mlp_fused_chunk(
        n_steps=N_STEPS, seed_and_t0=jnp.array([7, 0], jnp.int32),
        a_t=jnp.zeros((jax_k5.LANE, jax_k5.LANE), jnp.float32), packed=packed,
        batch=BATCH, data_dim=D, latent_dim=LATENT, enc_dims=enc_dims, dec_dims=dec_dims,
        dataset_kind="sigmoid", intrinsic_dim=DIM, var_added=0.0, eps_const=-3.0, tdv=tdv,
        lr=1e-3, external_noise=pad_noise(xs, z1s, z2s, N_STEPS, batch=BATCH,
                                          lane=jax_k5.LANE),
        interpret=True, dual=True)
    kstate = jax_k5.unpack_mlp_state(jstate, new_packed, N_STEPS, enc_dims, dec_dims, tdv,
                                     LATENT, dual=True)
    adam = _adam_state(kstate.opt_state)
    return kstate.params, adam.mu, adam.nu, int(adam.count), np.asarray(losses)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("tdv", [True, False])
def test_plain_k5_dual_matches_jax(reference, tdv):
    dataset, model, tx, jstate = jax_setup(tdv)
    xs, z1s, z2s = noise(dataset)
    state, losses = run_port(dataset, jstate, xs, z1s, z2s, tdv)
    if reference == "xla":
        params, opt, ref_losses = run_xla_steps(model, tx, jstate, jnp.asarray(xs),
                                                jnp.asarray(z1s), jnp.asarray(z2s))
        adam = _adam_state(opt)
        mu, nu, count = adam.mu, adam.nu, int(adam.count)
    else:
        params, mu, nu, count, ref_losses = run_pallas(dataset, model, jstate, xs, z1s, z2s,
                                                       tdv)
    np.testing.assert_allclose(losses, ref_losses, *TOL["loss"])
    assert state.count == count == N_STEPS and state.step == N_STEPS
    for got, ref, tol in ((state.params, params, "params"), (state.m, mu, "mu"),
                          (state.v, nu, "nu")):
        ref = flat(ref)
        assert set(got) == set(ref)
        assert "SigDecoder.FC2.kernel" in got
        for name, val in got.items():
            np.testing.assert_allclose(val.numpy(), ref[name], *TOL[tol],
                                       err_msg=f"{tol} {name}")


def test_dual_layout_appends_the_sig_decoder_and_round_trips():
    enc, dec = (8, 24, 16, LATENT), (LATENT, 24, 8)
    layout = k5.param_layout(enc, dec, dual=True)
    # K5's layout first, unchanged, then the SigDecoder's layers
    assert layout[:-4] == k5.param_layout(enc, dec)
    assert [n for n, _ in layout[-4:]] == [
        "SigDecoder.FC0.kernel", "SigDecoder.FC0.bias", "SigDecoder.FC1.kernel",
        "SigDecoder.FC1.bias"]
    assert k5.n_params(enc, dec, True) == k5.n_params(enc, dec) + 6 * 24 + 24 + 24 * 8 + 8
    # one layer a stack: K2's layout
    assert k5.param_layout((7, 6), (6, 7), True) == k1.param_layout(7, 6, dual=True)
    model = build_vae(data_dim=8, latent_dim=LATENT, encoder_layer_sizes="24|16",
                      decoder_layer_sizes="24", dataset_name="sigmoid")
    assert {n for n, _ in layout} - {"epsilon"} == set(dict(model.named_parameters()))
    rs = np.random.RandomState(3)
    tensors = {n: torch.as_tensor(rs.randn(*s).astype(np.float32)) for n, s in layout}
    state = TrainState(params=tensors, m={n: t * 2 for n, t in tensors.items()},
                       v={n: t * 3 for n, t in tensors.items()}, count=4, step=9,
                       data_seed=0, model_seed=0)
    p, m, v = k5.pack_state(state, enc, dec, dual=True)
    out = TrainState(params={n: torch.zeros_like(t) for n, t in tensors.items()},
                     m={n: torch.zeros_like(t) for n, t in tensors.items()},
                     v={n: torch.zeros_like(t) for n, t in tensors.items()},
                     count=4, step=9, data_seed=0, model_seed=0)
    out = k5.unpack_state(out, p, m, v, 2, enc, dec, dual=True)
    assert (out.count, out.step) == (6, 11)
    for n in tensors:
        assert torch.equal(out.params[n], tensors[n])
        assert torch.equal(out.m[n], tensors[n] * 2)
        assert torch.equal(out.v[n], tensors[n] * 3)


def _cfg(**kw):
    base = dict(batch_size=100, adam_dtype="f32", device="cuda", kernels="auto", nojit=False,
                learning_rate=1e-4)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture
def fake_h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))


def _mlp(dataset_name, data_dim=7):
    return build_vae(data_dim=data_dim, latent_dim=6, encoder_layer_sizes="200|200|200",
                     decoder_layer_sizes="200|200|200", epsilon=-3.0, tunable_decoder_var=True,
                     dataset_name=dataset_name)


def test_k5_dual_gating(fake_h100):
    sig = SigmoidDataset.create(69, 3, 3)
    ok, why = k5.supported(_mlp("sigmoid"), sig, _cfg())
    n_p = k5.n_params((7, 200, 200, 200, 6), (6, 200, 200, 200, 7), dual=True)
    assert ok and why == f"ReLU MLP VAE on sigmoid with the dual decoder, {n_p} parameters"
    # the sigmoid dataset without the dual decoder, and the dual decoder elsewhere
    ok, why = k5.supported(_mlp(None), sig, _cfg())
    assert not ok and why == "the sigmoid dataset expects the dual decoder"
    ok, why = k5.supported(_mlp("sigmoid", 6), SphereDataset(3, 3), _cfg())
    assert not ok and why == "the dual decoder expects the sigmoid dataset"
    ok, why = k5.supported(_mlp("sigmoid"), sig, _cfg(device="cpu"))
    assert not ok and "not a CUDA device" in why


def test_dispatch_names_k5_dual(fake_h100, capsys):
    sig = SigmoidDataset.create(69, 3, 3)
    dispatch.make_train_chunk(_mlp("sigmoid"), sig, _cfg(kernels="cuda"))
    out = capsys.readouterr().out
    assert out.startswith("[kernels] cuda: fused MLP-VAE kernel K5 (dual decoder) "
                          "(ReLU MLP VAE on sigmoid with the dual decoder")
    dispatch.make_train_chunk(_mlp("sigmoid"), sig, _cfg(kernels="torch"))
    assert "[kernels] torch: plain PyTorch path (--kernels torch)" in capsys.readouterr().out


def test_plain_dual_chunk_is_the_torch_path_bitwise():
    """On CPU tensors the wrapper runs the torch path itself: the same
    losses and state as ``train/step.py:train_chunk`` on the same model,
    bitwise, with the in-kernel sampler's counters (step0, t0, seeds)."""
    from vae_training_tpu_torch.train import step as torch_step

    sig = SigmoidDataset.create(5, DIM, PAD)
    model = build_vae(data_dim=sig.dimension, latent_dim=LATENT, encoder_layer_sizes=HIDDEN,
                      decoder_layer_sizes=HIDDEN, epsilon=-3.0, tunable_decoder_var=True,
                      dataset_name="sigmoid")
    model.init_parameters(4)
    state = TrainState.create(dict(model.named_parameters()), 31, 32)
    state.step, state.count = 7, 5
    enc, dec = k5.stack_widths(model)
    p, m, v = k5.pack_state(state, enc, dec, dual=True)
    losses = k5.run_mlp_fused_chunk(
        p, m, v, sig.A, n_steps=3, batch=BATCH, enc_widths=enc, dec_widths=dec,
        kind="sigmoid", intrinsic_dim=DIM, manifold_dim=DIM, step0=7, t0=5, data_seed=31,
        model_seed=32, var_added=0.0, eps_const=-3.0, tdv=True, lr=1e-3, dual=True)
    ref, ref_losses = torch_step.train_chunk(model, sig, state, 3, batch_size=BATCH, lr=1e-3)
    assert torch.equal(losses, ref_losses)
    for got, want in zip((p, m, v), k5.pack_state(ref, enc, dec, dual=True)):
        assert torch.equal(got, want)
