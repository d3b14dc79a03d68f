"""K5's plain version against both JAX references, and K5's host-side code.

K5 is the fused MLP-VAE training chunk (``vae_training_tpu_torch/csrc/
mlp_vae.cu``). The same initial parameters (the JAX package's flax init of
``HIDDEN`` ReLU stacks, carried across with ``state_from_flax``) and the
same numpy-drawn (x, z1, z2) streams go through

  - the port's ``run_mlp_fused_chunk`` on CPU tensors, i.e. its plain
    version (torch autograd + the explicit Adam update), and
  - the JAX package's jax.grad + optax reference (``run_xla_steps``) and its
    Pallas MLP kernel in interpret mode with external noise,

on the sphere and linear_gaussian manifolds, and must agree at
``tests/test_mlp_kernel.py``'s tolerances: losses rtol/atol 3e-4, params
rtol 1e-3 / atol 1e-5, Adam m rtol 1e-3 / atol 1e-6, v rtol 1e-3 /
atol 1e-9 (both sides are fp32; the deeper stacks' sums are taken in other
orders). The CUDA kernel itself is held against this plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_test_helpers import pad_noise, run_xla_steps  # noqa: E402
from vae_training_tpu.data import LinearGaussianDataset as JaxLinearGaussian  # noqa: E402
from vae_training_tpu.data import SphereDataset as JaxSphere  # noqa: E402
from vae_training_tpu.kernels import mlp_vae as jax_k5  # noqa: E402
from vae_training_tpu.kernels.linear_vae import _adam_state  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu_torch.data import (  # noqa: E402
    LinearGaussianDataset,
    SigmoidDataset,
    SphereDataset,
)
from vae_training_tpu_torch.kernels import dispatch  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.kernels import mlp_vae as k5  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.runio.export import state_from_flax  # noqa: E402

BATCH = 32
LATENT = 6
HIDDEN = "24|24"
DIM = 3
N_STEPS = 4
TOL = dict(loss=(3e-4, 3e-4), params=(1e-3, 1e-5), mu=(1e-3, 1e-6), nu=(1e-3, 1e-9))


def flat(tree):
    """Nested flax tree → {dotted name: numpy}."""
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_setup(kind, tdv):
    if kind == "sphere":
        dataset = JaxSphere(dim=DIM, padding_dim=5)
    else:
        dataset = JaxLinearGaussian.create(2, dimension=DIM, intrinsic_dimension=2,
                                           padding_dimension=5)
    D = dataset.dimension
    model = jax_build_vae(data_dim=D, latent_dim=LATENT, encoder_layer_sizes=HIDDEN,
                          decoder_layer_sizes=HIDDEN, epsilon=-3.0,
                          tunable_decoder_var=tdv)
    tx = make_adam(1e-3)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, D)),
                        jnp.zeros((1, LATENT)), jnp.zeros((1, D)))["params"]
    state = JaxTrainState.create(params=params, tx=tx,
                                 model_key=jax.random.PRNGKey(1),
                                 data_key=jax.random.PRNGKey(2))
    return dataset, model, tx, state


def noise(dataset, kind, seed=0):
    rs = np.random.RandomState(seed)
    D = dataset.dimension
    xs = np.zeros((N_STEPS, BATCH, D), np.float32)
    if kind == "sphere":
        g = rs.randn(N_STEPS, BATCH, DIM).astype(np.float32)
        xs[:, :, :DIM] = g / np.linalg.norm(g, axis=-1, keepdims=True)
    else:
        lat = rs.randn(N_STEPS, BATCH, dataset.intrinsic_dim).astype(np.float32)
        xs[:, :, :DIM] = lat @ np.asarray(dataset.A).T
    z1s = rs.randn(N_STEPS, BATCH, LATENT).astype(np.float32)
    z2s = rs.randn(N_STEPS, BATCH, D).astype(np.float32)
    return xs, z1s, z2s


def widths(D):
    hidden = tuple(int(h) for h in HIDDEN.split("|"))
    return (D,) + hidden + (LATENT,), (LATENT,) + hidden + (D,)


def run_port(dataset, kind, jstate, xs, z1s, z2s, tdv):
    adam = _adam_state(jstate.opt_state)
    state = state_from_flax(jax.device_get(jstate.params), jax.device_get(adam.mu),
                            jax.device_get(adam.nu), int(adam.count))
    enc, dec = widths(dataset.dimension)
    p, m, v = k5.pack_state(state, enc, dec)
    linear = kind == "linear"
    losses = k5.run_mlp_fused_chunk(
        p, m, v, torch.tensor(np.asarray(dataset.A)) if linear else None,
        n_steps=N_STEPS, batch=BATCH, enc_widths=enc, dec_widths=dec, kind=kind,
        intrinsic_dim=dataset.intrinsic_dim if linear else DIM, manifold_dim=DIM,
        step0=0, t0=state.count, data_seed=1, model_seed=2, var_added=0.0,
        eps_const=-3.0, tdv=tdv, lr=1e-3,
        external_noise=tuple(torch.as_tensor(a) for a in (xs, z1s, z2s)))
    state = k5.unpack_state(state, p, m, v, N_STEPS, enc, dec)
    return state, losses.numpy()


def run_pallas(dataset, kind, model, jstate, xs, z1s, z2s, tdv):
    D = dataset.dimension
    enc_dims = jax_k5._layer_dims(model.encoder_features, D)
    dec_dims = jax_k5._layer_dims(model.decoder_features, LATENT)
    packed = jax_k5.pack_mlp_state(jstate, enc_dims, dec_dims, tdv)
    new_packed, losses = jax_k5.run_mlp_fused_chunk(
        n_steps=N_STEPS, seed_and_t0=jnp.array([7, 0], jnp.int32),
        a_t=jnp.zeros((jax_k5.LANE, jax_k5.LANE), jnp.float32), packed=packed,
        batch=BATCH, data_dim=D, latent_dim=LATENT, enc_dims=enc_dims,
        dec_dims=dec_dims, dataset_kind=kind,
        intrinsic_dim=dataset.intrinsic_dim if kind == "linear" else DIM,
        var_added=0.0, eps_const=-3.0, tdv=tdv, lr=1e-3,
        external_noise=pad_noise(xs, z1s, z2s, N_STEPS, batch=BATCH, lane=jax_k5.LANE),
        interpret=True)
    kstate = jax_k5.unpack_mlp_state(jstate, new_packed, N_STEPS, enc_dims, dec_dims,
                                     tdv, LATENT)
    adam = _adam_state(kstate.opt_state)
    return kstate.params, adam.mu, adam.nu, int(adam.count), np.asarray(losses)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["sphere", "linear"])
@pytest.mark.parametrize("tdv", [True, False])
def test_plain_k5_matches_jax(reference, kind, tdv):
    dataset, model, tx, jstate = jax_setup(kind, tdv)
    xs, z1s, z2s = noise(dataset, kind)
    state, losses = run_port(dataset, kind, jstate, xs, z1s, z2s, tdv)
    if reference == "xla":
        params, opt, ref_losses = run_xla_steps(model, tx, jstate, jnp.asarray(xs),
                                                jnp.asarray(z1s), jnp.asarray(z2s))
        adam = _adam_state(opt)
        mu, nu, count = adam.mu, adam.nu, int(adam.count)
    else:
        params, mu, nu, count, ref_losses = run_pallas(dataset, kind, model, jstate,
                                                       xs, z1s, z2s, tdv)
    np.testing.assert_allclose(losses, ref_losses, *TOL["loss"])
    assert state.count == count == N_STEPS and state.step == N_STEPS
    for got, ref, tol in ((state.params, params, "params"), (state.m, mu, "mu"),
                          (state.v, nu, "nu")):
        ref = flat(ref)
        assert set(got) == set(ref)
        assert "Decoder.FC2.kernel" in got
        for name, val in got.items():
            np.testing.assert_allclose(val.numpy(), ref[name], *TOL[tol],
                                       err_msg=f"{tol} {name}")


def test_pack_unpack_round_trip():
    enc, dec = (8, 24, 16, LATENT), (LATENT, 24, 8)
    layout = k5.param_layout(enc, dec)
    assert [n for n, _ in layout] == [
        "Encoder.FC0.kernel", "Encoder.FC0.bias", "Encoder.FC1.kernel", "Encoder.FC1.bias",
        "Encoder.FC2.kernel", "Encoder.FC2.bias", "Decoder.FC0.kernel", "Decoder.FC0.bias",
        "Decoder.FC1.kernel", "Decoder.FC1.bias", "epsilon_p", "epsilon"]
    rs = np.random.RandomState(3)
    tensors = {n: torch.as_tensor(rs.randn(*s).astype(np.float32)) for n, s in layout}
    from vae_training_tpu_torch.train import TrainState

    state = TrainState(params=tensors, m={n: t * 2 for n, t in tensors.items()},
                       v={n: t * 3 for n, t in tensors.items()}, count=4, step=9,
                       data_seed=0, model_seed=0)
    p, m, v = k5.pack_state(state, enc, dec)
    assert p.shape == (k5.n_params(enc, dec),)
    out = TrainState(params={n: torch.zeros_like(t) for n, t in tensors.items()},
                     m={n: torch.zeros_like(t) for n, t in tensors.items()},
                     v={n: torch.zeros_like(t) for n, t in tensors.items()},
                     count=4, step=9, data_seed=0, model_seed=0)
    out = k5.unpack_state(out, p, m, v, 3, enc, dec)
    assert (out.count, out.step) == (7, 12)
    for n in tensors:
        assert torch.equal(out.params[n], tensors[n])
        assert torch.equal(out.m[n], tensors[n] * 2)
        assert torch.equal(out.v[n], tensors[n] * 3)
    # one layer a stack is K1's layout
    assert k5.param_layout((12, 20), (20, 12)) == k1.param_layout(12, 20)


def _cfg(**kw):
    base = dict(batch_size=100, adam_dtype="f32", device="cuda", kernels="auto", nojit=False,
                learning_rate=1e-4)
    base.update(kw)
    return SimpleNamespace(**base)


def _models():
    mlp = build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes="200|200|200",
                    decoder_layer_sizes="200|200|200", epsilon=-3.0, tunable_decoder_var=True)
    lin = build_vae(data_dim=6, latent_dim=6, epsilon=-3.0)
    return mlp, lin


def test_k5_gating(monkeypatch):
    sphere = SphereDataset(3, 3)
    mlp, lin = _models()
    ok, why = k5.supported(mlp, sphere, _cfg(device="cpu"))
    assert not ok and "not a CUDA device" in why
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    ok, why = k5.supported(mlp, sphere, _cfg())
    assert ok and "166019 parameters" in why
    ok, why = k5.supported(mlp, LinearGaussianDataset.create(2, 3, 3, 3), _cfg())
    assert ok and "linear_gaussian" in why
    # a hidden layer in one stack only is still the MLP kernel's
    half = build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes="", decoder_layer_sizes="32")
    assert k5.supported(half, sphere, _cfg())[0]
    ok, why = k5.supported(lin, sphere, _cfg())
    assert not ok and "linear kernel" in why
    sig_mlp = build_vae(data_dim=7, latent_dim=6, encoder_layer_sizes="16",
                        decoder_layer_sizes="16", dataset_name="sigmoid")
    # the sigmoid dataset's dual-decoder MLPs: K5's dual branch
    ok, why = k5.supported(sig_mlp, SigmoidDataset.create(69, 3, 3), _cfg())
    assert ok and "sigmoid with the dual decoder" in why
    deep = build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes="|".join(["8"] * 8))
    ok, why = k5.supported(deep, sphere, _cfg())
    assert not ok and "at most 8 layers" in why
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (8, 0))
    ok, why = k5.supported(mlp, sphere, _cfg())
    assert not ok and "sm_80" in why


def test_dispatch_lines_name_the_kernel(monkeypatch, capsys):
    sphere, sig = SphereDataset(3, 3), SigmoidDataset.create(69, 3, 3)
    mlp, lin = _models()
    dual = build_vae(data_dim=7, latent_dim=6, epsilon=-3.0, dataset_name="sigmoid")
    sig_mlp = build_vae(data_dim=7, latent_dim=6, encoder_layer_sizes="16",
                        decoder_layer_sizes="16", dataset_name="sigmoid")
    # on the CPU: the torch path, with the reason of the kernel the shape belongs to
    dispatch.make_train_chunk(mlp, sphere, _cfg(device="cpu"))
    assert ("[kernels] torch: plain PyTorch path (device 'cpu' is not a CUDA device)"
            in capsys.readouterr().out)
    with pytest.raises(RuntimeError, match="--kernels cuda requested") as e:
        dispatch.make_train_chunk(mlp, sphere, _cfg(device="cpu", kernels="cuda"))
    assert "linear kernel: " in str(e.value) and "MLP kernel: " in str(e.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    dispatch.make_train_chunk(mlp, sphere, _cfg())
    assert "[kernels] cuda: fused MLP-VAE kernel K5 (" in capsys.readouterr().out
    dispatch.make_train_chunk(dual, sig, _cfg())
    assert "[kernels] cuda: fused linear-VAE kernel K2 (" in capsys.readouterr().out
    dispatch.make_train_chunk(lin, LinearGaussianDataset.create(2, 3, 3, 3), _cfg())
    assert "[kernels] cuda: fused linear-VAE kernel K1 (" in capsys.readouterr().out
    dispatch.make_train_chunk(sig_mlp, sig, _cfg())
    assert "[kernels] cuda: fused MLP-VAE kernel K5 (dual decoder) (" in capsys.readouterr().out
    dispatch.make_train_chunk(sig_mlp, sig, _cfg(kernels="cuda"))
    assert "K5 (dual decoder)" in capsys.readouterr().out
