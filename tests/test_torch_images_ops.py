"""``ops/images.py`` against the JAX package's ``vae_training_tpu.ops.images``:
``tile_images`` bitwise (a layout op); ``resize_image`` up and down against
``jax.image.resize(..., "bilinear")`` to 1e-5 (two float32 sums of the
same triangle weights in another order), where
``torch.nn.functional.interpolate`` without antialiasing would miss by far
more on a shrink; ``img_tile`` writes the same PNG-ready image.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from vae_training_tpu.ops import images as ji  # noqa: E402
from vae_training_tpu_torch.ops import images as ti  # noqa: E402


@pytest.mark.parametrize("shape,aspect,border,color", [
    ((7, 5, 6, 3), 1.0, 1, 0.0), ((7, 5, 6), 1.7, 2, 0.3), ((16, 4, 4), 1.0, 0, 1.0),
    ((1, 3, 3, 1), 0.5, 1, 0.0)])
def test_tile_images_bitwise(shape, aspect, border, color):
    imgs = np.random.RandomState(len(shape)).uniform(-1, 1, shape).astype(np.float32)
    got = ti.tile_images(torch.as_tensor(imgs), aspect, border, color).numpy()
    np.testing.assert_array_equal(got, np.asarray(ji.tile_images(jnp.asarray(imgs), aspect,
                                                                 border, color)))


@pytest.mark.parametrize("src,dst", [
    ((17, 23), (40, 57)), ((64, 64), (256, 256)), ((2, 2), (5, 3)),  # up
    ((17, 23, 3), (7, 5)), ((100, 90), (7, 11)), ((5, 5), (1, 1)), ((9, 31), (4, 200)),
    ((30, 30, 2), (29, 31))])  # down, and one axis each way
def test_resize_image_matches_jax(src, dst):
    img = np.random.RandomState(src[0]).rand(*src).astype(np.float32)
    want = np.asarray(ji.resize_image(jnp.asarray(img), dst))
    got = ti.resize_image(torch.as_tensor(img), dst).numpy()
    assert got.shape == want.shape == dst + src[2:]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if any(d < s for d, s in zip(dst, src)):
        x = torch.as_tensor(img).reshape(*src[:2], -1).permute(2, 0, 1)[None]
        plain = F.interpolate(x, size=dst, mode="bilinear", align_corners=False)
        plain = plain[0].permute(1, 2, 0).reshape(want.shape).numpy()
        assert np.abs(plain - want).max() > 1e-3  # a shrink needs the antialiasing


def test_img_tile_writes_the_same_image(tmp_path):
    imgs = np.random.RandomState(0).uniform(-1, 1, (9, 8, 8)).astype(np.float32)
    fn = tmp_path / "tile.png"
    got = ti.img_tile(torch.as_tensor(imgs), str(fn), save=True)
    want = ji.img_tile(imgs, None, save=False)
    assert got.shape == want.shape == (256, 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert fn.exists() and fn.stat().st_size > 0
