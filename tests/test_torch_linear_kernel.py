"""K1's plain version against both JAX references, and K1's host-side code.

The same initial parameters (the JAX package's flax init, carried across
with ``state_from_flax``) and the same numpy-drawn (x, z1, z2) streams go
through

  - the port's ``run_fused_chunk`` on CPU tensors, i.e. its plain version
    (torch autograd + the explicit Adam update), and
  - the JAX package's jax.grad + optax reference (``run_xla_steps``) and its
    Pallas kernel in interpret mode with external noise,

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
from vae_training_tpu.data import LinearGaussianDataset as JaxLinearGaussian  # noqa: E402
from vae_training_tpu.kernels import linear_vae as jax_k1  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu_torch.data import LinearGaussianDataset  # noqa: E402
from vae_training_tpu_torch.kernels import dispatch  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.runio.export import state_from_flax  # noqa: E402

BATCH = 32
LATENT = 20
INTRINSIC = 3
PAD = 9
D = INTRINSIC + PAD
N_STEPS = 5
TOL = dict(loss=(2e-4, 2e-4), params=(5e-4, 5e-5), mu=(5e-4, 1e-6), nu=(5e-4, 1e-7))


def flat(tree):
    """Nested flax tree → {dotted name: numpy}."""
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_setup(tdv):
    dataset = JaxLinearGaussian.create(2, dimension=INTRINSIC,
                                       intrinsic_dimension=INTRINSIC,
                                       padding_dimension=PAD)
    model = jax_build_vae(data_dim=D, latent_dim=LATENT, encoder_layer_sizes="",
                          decoder_layer_sizes="", epsilon=-1.0,
                          tunable_decoder_var=tdv)
    tx = make_adam(1e-3)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, D)),
                        jnp.zeros((1, LATENT)), jnp.zeros((1, D)))["params"]
    state = JaxTrainState.create(params=params, tx=tx,
                                 model_key=jax.random.PRNGKey(1),
                                 data_key=jax.random.PRNGKey(2))
    return dataset, model, tx, state


def noise(dataset, seed=0):
    rs = np.random.RandomState(seed)
    lat = rs.randn(N_STEPS, BATCH, INTRINSIC).astype(np.float32)
    xs = np.zeros((N_STEPS, BATCH, D), np.float32)
    xs[:, :, :INTRINSIC] = lat @ np.asarray(dataset.A).T
    z1s = rs.randn(N_STEPS, BATCH, LATENT).astype(np.float32)
    z2s = rs.randn(N_STEPS, BATCH, D).astype(np.float32)
    return xs, z1s, z2s


def port_state(jstate):
    adam = jax_k1._adam_state(jstate.opt_state)
    return state_from_flax(jax.device_get(jstate.params), jax.device_get(adam.mu),
                           jax.device_get(adam.nu), int(adam.count))


def run_port(dataset, jstate, xs, z1s, z2s, tdv):
    state = port_state(jstate)
    p, m, v = k1.pack_state(state, D, LATENT)
    losses = k1.run_fused_chunk(
        p, m, v, torch.tensor(np.asarray(dataset.A)), n_steps=N_STEPS,
        batch=BATCH, data_dim=D, latent_dim=LATENT, intrinsic_dim=INTRINSIC,
        manifold_dim=INTRINSIC, step0=0, t0=state.count, data_seed=1,
        model_seed=2, var_added=0.0, eps_const=-1.0, tdv=tdv, lr=1e-3,
        external_noise=tuple(torch.as_tensor(a) for a in (xs, z1s, z2s)))
    state = k1.unpack_state(state, p, m, v, N_STEPS, D, LATENT)
    return state, losses.numpy()


def run_pallas(dataset, jstate, xs, z1s, z2s, tdv):
    xp, z1p, z2p = pad_noise(xs, z1s, z2s, N_STEPS, batch=BATCH, lane=jax_k1.N)
    bufs = jax_k1.pack_state(jstate, D, LATENT, tdv)
    new_bufs, losses = jax_k1.run_fused_chunk(
        n_steps=N_STEPS, seed_and_t0=jnp.array([123, 0], jnp.int32),
        a_t=jnp.zeros((jax_k1.N, jax_k1.N), jnp.float32), buffers=bufs,
        batch=BATCH, data_dim=D, latent_dim=LATENT, intrinsic_dim=INTRINSIC,
        var_added=0.0, eps_const=-1.0, tdv=tdv, lr=1e-3,
        external_noise=(xp, z1p, z2p), interpret=True)
    kstate = jax_k1.unpack_state(jstate, new_bufs, N_STEPS, D, LATENT, tdv)
    adam = jax_k1._adam_state(kstate.opt_state)
    return kstate.params, adam.mu, adam.nu, int(adam.count), np.asarray(losses)


def run_xla(model, tx, jstate, xs, z1s, z2s):
    params, opt, losses = run_xla_steps(model, tx, jstate, jnp.asarray(xs),
                                        jnp.asarray(z1s), jnp.asarray(z2s))
    adam = jax_k1._adam_state(opt)
    return params, adam.mu, adam.nu, int(adam.count), losses


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("tdv", [True, False])
def test_plain_k1_matches_jax(reference, tdv):
    dataset, model, tx, jstate = jax_setup(tdv)
    xs, z1s, z2s = noise(dataset)
    state, losses = run_port(dataset, jstate, xs, z1s, z2s, tdv)
    if reference == "xla":
        params, mu, nu, count, ref_losses = run_xla(model, tx, jstate, xs, z1s, z2s)
    else:
        params, mu, nu, count, ref_losses = run_pallas(dataset, jstate, xs, z1s, z2s, tdv)
    np.testing.assert_allclose(losses, ref_losses, *TOL["loss"])
    assert state.count == count == N_STEPS and state.step == N_STEPS
    for got, ref, tol in ((state.params, params, "params"), (state.m, mu, "mu"),
                          (state.v, nu, "nu")):
        ref = flat(ref)
        assert set(got) == set(ref)
        for name, val in got.items():
            np.testing.assert_allclose(val.numpy(), ref[name], *TOL[tol],
                                       err_msg=f"{tol} {name}")


def test_pack_unpack_round_trip():
    rs = np.random.RandomState(3)
    names = [n for n, _ in k1.param_layout(D, LATENT)]
    tensors = {n: torch.as_tensor(rs.randn(*s).astype(np.float32))
               for n, s in k1.param_layout(D, LATENT)}
    buf = k1.pack(tensors, D, LATENT)
    assert buf.shape == (k1.n_params(D, LATENT),)
    out = {n: torch.zeros_like(t) for n, t in tensors.items()}
    k1.unpack_(buf, out, D, LATENT)
    for n in names:
        assert torch.equal(out[n], tensors[n])
    # without -tdv the epsilon slot is packed as zero and never unpacked
    del tensors["epsilon"]
    assert k1.pack(tensors, D, LATENT)[-1].item() == 0.0


def _cfg(**kw):
    base = dict(batch_size=100, adam_dtype="f32", device="cuda", kernels="auto", nojit=False,
                learning_rate=1e-3)
    base.update(kw)
    return SimpleNamespace(**base)


def test_supported_gating(monkeypatch):
    dataset = LinearGaussianDataset.create(2, 3, 3, 9)
    model = build_vae(data_dim=12, latent_dim=20, epsilon=-1.0,
                      tunable_decoder_var=True)
    ok, why = k1.supported(model, dataset, _cfg(device="cpu"))
    assert not ok and "not a CUDA device" in why
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    ok, why = k1.supported(model, dataset, _cfg())
    assert ok, why
    mlp = build_vae(data_dim=12, latent_dim=20, encoder_layer_sizes="16",
                    decoder_layer_sizes="16")
    ok, why = k1.supported(mlp, dataset, _cfg())
    assert not ok and "0-hidden-layer" in why
    ok, why = k1.supported(model, dataset, _cfg(batch_size=4096))
    assert not ok and "shared memory" in why
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (8, 0))
    ok, why = k1.supported(model, dataset, _cfg())
    assert not ok and "sm_80" in why


@pytest.mark.parametrize("dd,pd,ld", [(3, 9, 20), (3, 17, 20), (6, 6, 20), (6, 14, 20),
                                      (9, 3, 20), (9, 11, 10), (12, 8, 10)])
def test_every_linear_sweep_row_fits_shared_memory(dd, pd, ld):
    # the rows of seed_linpadding_expts.sh at batch 100
    assert k1.smem_bytes(100, dd + pd, ld, dd, dd) <= k1.SMEM_LIMIT


def test_dispatch_paths(capsys):
    dataset = LinearGaussianDataset.create(2, 3, 3, 9)
    model = build_vae(data_dim=12, latent_dim=20, epsilon=-1.0)
    dispatch.make_train_chunk(model, dataset, _cfg(device="cpu"))
    assert "torch: plain PyTorch path (device 'cpu' is not a CUDA device)" in capsys.readouterr().out
    dispatch.make_train_chunk(model, dataset, _cfg(kernels="torch"))
    assert "(--kernels torch)" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="--kernels cuda requested"):
        dispatch.make_train_chunk(model, dataset, _cfg(device="cpu", kernels="cuda"))
    with pytest.raises(ValueError, match="-nojit"):
        dispatch.make_train_chunk(model, dataset, _cfg(kernels="cuda", nojit=True))
