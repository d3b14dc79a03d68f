"""The port's ELBO, VAE and Adam against the JAX package on the same inputs.

Inputs are drawn with numpy from a seed; parameters come from the JAX
package's flax init, carried across with ``state_from_flax``. Both sides
compute in fp32 on the CPU, so rtol 1e-5 / atol 1e-6 leaves room only for
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.ops import elbo_terms as jax_elbo_terms  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.ops import elbo_terms  # noqa: E402
from vae_training_tpu_torch.runio.export import state_from_flax  # noqa: E402
from vae_training_tpu_torch.train import adam_update_, generate  # noqa: E402
from vae_training_tpu_torch.train.step import loss_terms  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
D, L, B = 12, 20, 16


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("eps_shape", [(), (1,)])
def test_elbo_terms_match(eps_shape):
    rs = np.random.RandomState(0)
    x, x_hat = rs.randn(B, D).astype(np.float32), rs.randn(B, D).astype(np.float32)
    mu, logvar = rs.randn(B, L).astype(np.float32), rs.randn(L).astype(np.float32) * 0.3
    eps = np.asarray(rs.randn(*eps_shape) * 0.5, np.float32)
    got = elbo_terms(*(torch.as_tensor(a) for a in (x, x_hat, mu, logvar, eps)))
    ref = jax_elbo_terms(*(jnp.asarray(a) for a in (x, x_hat, mu, logvar, eps)))
    for g, r, name in zip(got, ref, ("loss", "dkl", "mse")):
        _close(g, r, msg=name)


def _models(enc, dec, tdv):
    jm = jax_build_vae(data_dim=D, latent_dim=L, encoder_layer_sizes=enc,
                       decoder_layer_sizes=dec, epsilon=-1.0, tunable_decoder_var=tdv)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, D)), jnp.zeros((1, L)),
                     jnp.zeros((1, D)))["params"]
    tm = build_vae(data_dim=D, latent_dim=L, encoder_layer_sizes=enc,
                   decoder_layer_sizes=dec, epsilon=-1.0, tunable_decoder_var=tdv)
    zeros = jax.tree_util.tree_map(np.zeros_like, jax.device_get(params))
    state = state_from_flax(jax.device_get(params), zeros, zeros, 0)
    return jm, params, tm, state


@pytest.mark.parametrize("enc,dec,tdv", [("", "", True), ("", "", False),
                                         ("16|8", "8", True)])
def test_vae_forward_and_generate_match_flax(enc, dec, tdv):
    jm, jparams, tm, state = _models(enc, dec, tdv)
    assert set(state.params) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        assert tuple(state.params[name].shape) == tuple(p.shape), name
    rs = np.random.RandomState(1)
    x, z1, z2 = (rs.randn(B, d).astype(np.float32) for d in (D, L, D))
    out = loss_terms(tm, state.params, *(torch.as_tensor(a) for a in (x, z1, z2)))
    x_hat, mu, logvar_e, eps = jm.apply({"params": jparams}, x, z1, z2)
    ref_loss = jax_elbo_terms(x, x_hat, mu, logvar_e, eps)
    for g, r, name in zip(out[:3], ref_loss, ("loss", "dkl", "mse")):
        _close(g.detach(), r, msg=name)
    _close(out[3].detach(), logvar_e)
    _close(out[4].detach(), eps)
    got_xhat = torch.func.functional_call(tm, state.params, tuple(
        torch.as_tensor(a) for a in (x, z1, z2)))[0]
    _close(got_xhat.detach(), x_hat)
    gen = generate(tm, state.params, torch.as_tensor(z1), torch.as_tensor(z2),
                   torch.tensor(-0.7))
    ref_gen = jm.apply({"params": jparams}, z1, z2, jnp.float32(-0.7),
                       method=type(jm).generate)
    _close(gen, ref_gen)


def test_init_follows_flax_lecun_normal():
    tm = build_vae(data_dim=256, latent_dim=L, encoder_layer_sizes="512",
                   decoder_layer_sizes="", epsilon=-1.0, tunable_decoder_var=True)
    tm.init_parameters(0)
    params = dict(tm.named_parameters())
    w = params["Encoder.FC0.kernel"].detach()
    assert w.shape == (256, 512)
    # lecun_normal: std sqrt(1/fan_in) after truncation at ±2 sigma of the
    # underlying normal (bound 2·sqrt(1/fan_in)/0.8796); 131k samples put
    # the std within ~0.3% at 1 sigma
    std = float(np.sqrt(1.0 / 256))
    assert abs(w.std().item() / std - 1.0) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.87962566 + 1e-6
    assert torch.all(params["Encoder.FC0.bias"] == 0)
    assert torch.all(params["epsilon_p"] == 1) and torch.all(params["epsilon"] == 1)
    tm2 = build_vae(data_dim=256, latent_dim=L, encoder_layer_sizes="512",
                    decoder_layer_sizes="", epsilon=-1.0, tunable_decoder_var=True)
    tm2.init_parameters(0)
    assert torch.equal(w, tm2.Encoder.FC0.kernel.detach())


def test_adam_update_matches_optax():
    rs = np.random.RandomState(2)
    p0 = rs.randn(7, 5).astype(np.float32)
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jp, jopt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p, m, v = torch.tensor(p0), torch.zeros(7, 5), torch.zeros(7, 5)
    for count in range(1, 6):
        g = rs.randn(7, 5).astype(np.float32)
        upd, jopt = tx.update(jnp.asarray(g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        adam_update_(p, m, v, torch.as_tensor(g), count, 1e-3)
    _close(p, jp, rtol=1e-6, atol=1e-7)
    _close(m, jopt[0].mu, rtol=1e-6, atol=1e-7)
    _close(v, jopt[0].nu, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(16, 12), (5, 3, 4), (7,)])
def test_binary_cross_entropy_matches_jax(shape):
    from vae_training_tpu.ops.elbo import binary_cross_entropy as jax_bce
    from vae_training_tpu_torch.ops import binary_cross_entropy

    rs = np.random.RandomState(3)
    probs = rs.uniform(0.01, 0.99, shape).astype(np.float32)
    labels = (rs.uniform(size=shape) > 0.5).astype(np.float32)
    got = binary_cross_entropy(torch.as_tensor(probs), torch.as_tensor(labels))
    ref = jax_bce(jnp.asarray(probs), jnp.asarray(labels))
    assert tuple(got.shape) == ref.shape == shape[:1]
    _close(got, ref)


@pytest.mark.parametrize("shape,val", [((4, 4), 0.0), ((3, 5), 2.5), ((2, 6, 3), -1.0)])
def test_fill_diagonal_matches_jax(shape, val):
    from vae_training_tpu.ops.elbo import fill_diagonal as jax_fill
    from vae_training_tpu_torch.ops import fill_diagonal

    a = np.random.RandomState(4).randn(*shape).astype(np.float32)
    t = torch.as_tensor(a)
    got = fill_diagonal(t, val)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fill(jnp.asarray(a), val)))
    np.testing.assert_array_equal(t.numpy(), a)  # a copy: the input is left as it was


def test_fill_diagonal_needs_two_dims():
    from vae_training_tpu.ops.elbo import fill_diagonal as jax_fill
    from vae_training_tpu_torch.ops import fill_diagonal

    for fill, arr in ((fill_diagonal, torch.zeros(3)), (jax_fill, jnp.zeros(3))):
        with pytest.raises(ValueError, match="ndim >= 2"):
            fill(arr, 1.0)


def test_loss_never_undercuts_the_closed_form_floor(tmp_path):
    """Assert (1) of tests/test_convergence_oracles.py's closed-form floor
    oracle on the port, over 2000 steps on the CPU: the mean loss of every
    100-step chunk stays above L*(ε) at the chunk's mid ε (the JAX oracle's
    -0.25 margin), for the port's own dataset matrix A."""
    import math

    from vae_training_tpu_torch.config import RunConfig
    from vae_training_tpu_torch.data import get_dataset
    from vae_training_tpu_torch.runio import make_output_dir
    from vae_training_tpu_torch.train.loop import Trainer

    cfg = RunConfig(
        name="floor", dataset="linear_gaussian", encoder_layer_sizes="", layer_sizes="",
        latent_dimension=8, padding_dim=5, dataset_dimension=3,
        dataset_intrinsic_dimension=3, num_batches=20000, batch_size=100,
        learning_rate=1e-3, epsilon=-1.0, tunable_decoder_var=True, dataset_seed=2,
        overwrite=True, tqdm=False, data_dir=str(tmp_path), device="cpu").validate()
    out = make_output_dir(cfg.name, True, cfg, data_dir=cfg.data_dir)
    ds = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
    trainer = Trainer(cfg, ds, out)
    D = ds.dimension
    s2 = np.sort(np.linalg.svd(ds.A.numpy().astype(np.float64), compute_uv=False) ** 2)[::-1]

    def floor(eps):
        active = s2 > math.exp(eps)
        return float(np.sum(active * (0.5 + 0.5 * np.log(s2) - 0.5 * eps))
                     + 0.5 * D + 0.5 * D * (math.log(2 * math.pi) + eps))

    def eps_now():
        return float(trainer.state.params["epsilon"][0]) * -1.0

    gaps = []
    for _ in range(20):
        eps_a = eps_now()
        trainer.state, losses = trainer.train_chunk(trainer.state, 100)
        gaps.append(float(losses.mean()) - floor(0.5 * (eps_a + eps_now())))
    assert np.all(np.isfinite(gaps))
    assert min(gaps) > -0.25, f"the loss undercuts the analytic floor: gaps {gaps}"
    assert gaps[-1] < gaps[0]  # training moves toward the floor
