"""The port's image corpora (``data/images.py``) and conv VAE
(``models/conv.py``) against the JAX package's, on the CPU.

  - ``synthetic_digits`` gives the JAX corpus bitwise (numpy on the same
    ``RandomState`` in both);
  - ``from_npz`` in every ``pixel_range`` mode, with the metadata array and
    the ``auto`` rules (with their stderr notices), gives JAX's corpus
    bitwise; an unknown mode raises; ``save``/``load`` round-trip;
  - ``from_folder`` on PNGs written here gives JAX's corpus: bitwise without
    a resize, within 1e-5 with one (``jax.image.resize`` against
    ``ops/images.py``'s ``resize_image``);
  - ``sample`` and ``epoch_permutation`` are counter-keyed: a permutation of
    ``range(n)``, other by epoch, the same at a tensor counter;
  - the conv VAE's forward and ``generate`` from parameters carried across
    from flax equal flax's (rtol 1e-5 / atol 1e-5: fp32 on both sides,
    summation order only), at 8×8×1 and 16×16×3 (the NHWC flatten order),
    with 4|8 and 4|8|8 (the transposed conv's crop at a third stage), flat
    and NHWC input; the ELBO's autograd gradients equal ``jax.grad``'s
    (rtol 1e-4 / atol 1e-6); the parameter names and shapes are flax's; a
    size the stack cannot halve raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu.data.images import ImageDataset as JaxImageDataset  # noqa: E402
from vae_training_tpu.models.conv import build_conv_vae as jax_build_conv  # noqa: E402
from vae_training_tpu.ops import elbo_terms as jax_elbo_terms  # noqa: E402
from vae_training_tpu_torch.data import ImageDataset  # noqa: E402
from vae_training_tpu_torch.models.conv import build_conv_vae  # noqa: E402
from vae_training_tpu_torch.runio.export import state_from_flax  # noqa: E402
from vae_training_tpu_torch.train.step import loss_terms  # noqa: E402

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed,n,size", [(0, 16, 8), (3, 12, 28), (7, 5, 16)])
def test_synthetic_digits_equal_jax_bitwise(seed, n, size):
    port = ImageDataset.synthetic_digits(seed, n=n, size=size)
    ref = JaxImageDataset.synthetic_digits(seed, n=n, size=size)
    np.testing.assert_array_equal(port.images.numpy(), np.asarray(ref.images))
    assert port.shape == ref.shape and port.dimension == ref.dimension and port.n == n
    assert port.is_epochs and ref.is_epochs


def _corpora():
    rs = np.random.RandomState(0)
    return {
        "float01": rs.rand(6, 8, 8).astype(np.float32),
        "uint8_255": rs.randint(0, 256, (4, 8, 8, 3)).astype(np.uint8),
        "binary": (rs.rand(4, 8, 8) > 0.5).astype(np.uint8),
        "ternary": rs.choice(np.array([-1, 0, 1], np.int8), size=(4, 8, 8)),
        "pm1": (rs.rand(5, 6, 6, 1) * 2 - 1).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_corpora()))
@pytest.mark.parametrize("pixel_range", ["auto", "0_255", "0_1", "pm1", "meta"])
def test_from_npz_matches_jax(tmp_path, capfd, name, pixel_range):
    arr = _corpora()[name]
    path = str(tmp_path / "c.npz")
    if pixel_range == "meta":  # the metadata array decides under "auto"
        np.savez(path, images=arr, pixel_range="pm1")
        pixel_range = "auto"
    else:
        np.savez(path, images=arr)
    ref = JaxImageDataset.from_npz(path, pixel_range=pixel_range)
    jax_err = capfd.readouterr().err
    port = ImageDataset.from_npz(path, pixel_range=pixel_range)
    assert capfd.readouterr().err == jax_err  # the same notices
    np.testing.assert_array_equal(port.images.numpy(), np.asarray(ref.images))
    assert port.shape == ref.shape


def test_from_npz_rejects_an_unknown_range(tmp_path):
    path = str(tmp_path / "c.npz")
    np.savez(path, images=np.zeros((2, 4, 4), np.float32))
    with pytest.raises(ValueError, match="pixel_range"):
        ImageDataset.from_npz(path, pixel_range="bogus")


def test_save_load_round_trip_in_both_packages(tmp_path):
    """The pm1 marker keeps an all-nonnegative corpus from being remapped
    again; a port save loads in the JAX package and back."""
    bright = np.full((4, 8, 8, 1), 0.5, np.float32)
    ds = ImageDataset(bright)
    ds.save(str(tmp_path / "d"))
    back = ds.load(str(tmp_path / "d"))
    np.testing.assert_array_equal(back.images.numpy(), bright)
    ref = JaxImageDataset.from_npz(str(tmp_path / "d.npz"))
    np.testing.assert_array_equal(np.asarray(ref.images), bright)


@pytest.mark.parametrize("size", [None, 6, 12], ids=["no-resize", "shrink", "grow"])
@pytest.mark.parametrize("channels", [1, 3])
def test_from_folder_matches_jax(tmp_path, size, channels):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rs = np.random.RandomState(channels)
    for i in range(3):
        img = rs.rand(8, 8) if channels == 1 else rs.rand(8, 8, 3)
        plt.imsave(str(tmp_path / f"im{i}.png"), img, cmap="gray" if channels == 1 else None)
    (tmp_path / "notes.txt").write_text("not an image")
    ref = JaxImageDataset.from_folder(str(tmp_path), size=size)
    port = ImageDataset.from_folder(str(tmp_path), size=size)
    assert port.shape == ref.shape == ((size or 8), (size or 8), 3)  # PNGs are RGBA
    if size is None:
        np.testing.assert_array_equal(port.images.numpy(), np.asarray(ref.images))
    else:
        np.testing.assert_allclose(port.images.numpy(), np.asarray(ref.images), rtol=0,
                                   atol=1e-5)


def test_from_folder_without_images_raises(tmp_path):
    with pytest.raises(ValueError, match="no images"):
        ImageDataset.from_folder(str(tmp_path))


def test_sample_and_permutation_are_counter_keyed():
    ds = ImageDataset.synthetic_digits(1, n=20, size=8)
    for epoch in range(3):
        perm = ds.epoch_permutation(99, epoch)
        assert perm.dtype == torch.int64 and sorted(perm.tolist()) == list(range(20))
        assert torch.equal(perm, ds.epoch_permutation(99, epoch))
    assert not torch.equal(ds.epoch_permutation(99, 0), ds.epoch_permutation(99, 1))
    assert not torch.equal(ds.epoch_permutation(99, 0), ds.epoch_permutation(98, 0))
    batch = ds.sample(5, 3, 7)
    assert batch.shape == (7, 64)
    assert torch.equal(batch, ds.sample(5, torch.tensor(3), 7))
    assert not torch.equal(batch, ds.sample(5, 4, 7))
    # every row is one corpus image, flattened in NHWC order
    flat = ds.images.reshape(20, -1)
    assert all(any(torch.equal(r, f) for f in flat) for r in batch)
    assert ds.score(batch) == {} and ds.score_batch(batch) == {}


CASES = [((8, 8, 1), "4|8"), ((16, 16, 3), "4|8"), ((16, 16, 3), "4|8|8")]


def _pair(hwc, channels, tdv=True, latent=5):
    jm = jax_build_conv(image_hwc=hwc, latent_dim=latent, channels_spec=channels,
                        epsilon=-1.0, tunable_decoder_var=tdv)
    d = int(np.prod(hwc))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, d)), jnp.zeros((1, latent)),
                     jnp.zeros((1, d)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = build_conv_vae(image_hwc=hwc, latent_dim=latent, channels_spec=channels,
                          epsilon=-1.0, tunable_decoder_var=tdv)
    state = state_from_flax(params, params, params, 0)
    return jm, params, port, state.params


def _inputs(hwc, latent=5, n=6, seed=0):
    rs = np.random.RandomState(seed)
    d = int(np.prod(hwc))
    return (rs.randn(n, d).astype(np.float32), rs.randn(n, latent).astype(np.float32),
            rs.randn(n, d).astype(np.float32))


@pytest.mark.parametrize("hwc,channels", CASES)
@pytest.mark.parametrize("layout", ["flat", "nhwc"])
def test_forward_and_generate_equal_flax(hwc, channels, layout):
    jm, jparams, port, params = _pair(hwc, channels)
    x, z1, z2 = _inputs(hwc)
    if layout == "nhwc":
        x = x.reshape(-1, *hwc)
    ref = jm.apply({"params": jparams}, x, z1, z2)
    got = torch.func.functional_call(port, params, tuple(map(torch.as_tensor, (x, z1, z2))))
    for name, a, b in zip(("x_hat", "mu", "logvar_e", "epsilon"), got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD_TOL,
                                   err_msg=name)
    eps = np.float32(-0.7)
    ref = jm.apply({"params": jparams}, z1, z2, eps, method=type(jm).generate)
    got = torch.func.functional_call(port, params, (None, torch.as_tensor(z1),
                                                    torch.as_tensor(z2), torch.tensor(eps)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("hwc,channels", CASES)
@pytest.mark.parametrize("tdv", [True, False])
def test_elbo_gradients_equal_jax_grad(hwc, channels, tdv):
    jm, jparams, port, params = _pair(hwc, channels, tdv)
    x, z1, z2 = _inputs(hwc, seed=1)

    def jax_loss(p):
        out = jm.apply({"params": p}, x, z1, z2)
        return jax_elbo_terms(x, *out)[0]

    jloss, jgrads = jax.value_and_grad(jax_loss)(jparams)
    jgrads = state_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), jparams, jparams,
                             0).params
    leaves = {k: p.clone().requires_grad_(True) for k, p in params.items()}
    loss = loss_terms(port, leaves, *map(torch.as_tensor, (x, z1, z2)))[0]
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    assert set(grads) == set(jgrads)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k].numpy(), **GRAD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("hwc,channels", CASES + [((28, 28, 1), "32|64")])
def test_parameters_carry_flax_names_layouts_and_init(hwc, channels):
    _, jparams, port, params = _pair(hwc, channels)
    port.init_parameters(3)
    mine = dict(port.named_parameters())
    assert {k: tuple(t.shape) for k, t in mine.items()} == \
        {k: tuple(t.shape) for k, t in params.items()}
    assert {"Encoder.Conv0.kernel", "Encoder.FCmu.kernel", "Decoder.FCin.kernel",
            "Decoder.UpOut.kernel", "epsilon_p", "epsilon"} <= set(mine)
    for k, t in mine.items():
        if k.endswith("bias"):
            assert not t.any(), k
        elif k.startswith("epsilon"):
            assert torch.equal(t, torch.ones_like(t)), k
        else:  # lecun_normal: std sqrt(1/fan_in), truncated at 2 sigma
            fan_in = int(np.prod(t.shape[:-1]))
            assert t.abs().max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.8796 + 1e-6, k
    again = build_conv_vae(image_hwc=hwc, latent_dim=5, channels_spec=channels,
                           epsilon=-1.0, tunable_decoder_var=True)
    again.init_parameters(3)
    for (k, a), b in zip(mine.items(), again.parameters()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("hwc,channels", [((18, 18, 1), "32|64"), ((16, 16, 1), "4|8|8|8|8")])
def test_a_size_the_stack_cannot_halve_raises(hwc, channels):
    with pytest.raises(ValueError, match="divisible"):
        build_conv_vae(image_hwc=hwc, latent_dim=4, channels_spec=channels)
