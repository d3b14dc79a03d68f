"""Image tiling and bilinear resize, the reference's image helpers.

Port of ``vae_training_tpu/ops/images.py``: generated images tiled into
one grid image, resized, and written as a PNG with matplotlib (the
reference used OpenCV; neither package does). ``resize_image`` must be
``jax.image.resize(..., "bilinear")``: a triangle kernel at half-pixel
centres, widened by the shrink factor where an axis shrinks
(antialiasing), the weights normalised to sum to one.
``torch.nn.functional.interpolate`` computes that with ``antialias=True``
(``tests/test_torch_images_ops.py`` holds it to JAX's, up and down, at
odd sizes); without it a shrink differs by up to 0.44 on uniform noise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def tile_images(imgs: torch.Tensor, aspect_ratio: float = 1.0, border: int = 1,
                border_color: float = 0.0) -> torch.Tensor:
    """Arrange (n, h, w[, c]) images in [-1, 1] into one grid image in
    [0, 1]: the grid's shape from sqrt(n·aspect), ``border`` pixels of
    ``border_color`` between tiles and in the empty cells."""
    imgs = torch.as_tensor(imgs)
    if imgs.ndim not in (3, 4):
        raise ValueError("imgs has wrong number of dimensions.")
    squeeze_channel = imgs.ndim == 3
    if squeeze_channel:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    aspect = aspect_ratio * (w / float(h))
    th = int(math.ceil(math.sqrt(n * aspect)))
    tw = int(math.ceil(math.sqrt(n / aspect)))
    cells = torch.cat([(imgs + 1.0) / 2.0,
                       torch.full((th * tw - n, h, w, c), border_color, dtype=imgs.dtype)])
    cells = torch.nn.functional.pad(cells, (0, 0, 0, border, 0, border), value=border_color)
    grid = cells.reshape(th, tw, h + border, w + border, c).permute(0, 2, 1, 3, 4)
    grid = grid.reshape(th * (h + border), tw * (w + border), c)
    grid = grid[: th * (h + border) - border, : tw * (w + border) - border]
    return grid[..., 0] if squeeze_channel else grid


def resize_image(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the first two axes of (H, W[, C]) to ``shape``,
    as ``jax.image.resize(img, shape + img.shape[2:], "bilinear")``: half-
    pixel centres, antialiased where an axis shrinks."""
    img = torch.as_tensor(img, dtype=torch.float32)
    h, w, rest = img.shape[0], img.shape[1], img.shape[2:]
    x = img.reshape(h, w, -1).permute(2, 0, 1)[None]  # (1, C, H, W)
    y = F.interpolate(x, size=tuple(shape), mode="bilinear", align_corners=False,
                      antialias=True)
    return y[0].permute(1, 2, 0).reshape(*shape, *rest)


def img_tile(imgs, fn: Optional[str], save: bool, aspect_ratio: float = 1.0,
             border: int = 1, border_color: float = 0.0,
             resize_to: Tuple[int, int] = (256, 256)) -> np.ndarray:
    """The reference's entry point: tile, resize, clip to [0, 1], and with
    ``save`` write the PNG ``fn`` (grey for one channel). Returns the image
    as a numpy array."""
    tile = resize_image(tile_images(torch.as_tensor(imgs), aspect_ratio, border, border_color),
                        resize_to)
    tile = np.clip(tile.detach().cpu().numpy(), 0.0, 1.0)
    if save and fn is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(fn, tile, cmap="gray" if tile.ndim == 2 else None)
    return tile
