"""Epoch-mode image corpora for the conv-VAE configuration.

Port of ``vae_training_tpu/data/images.py``. The whole corpus lives on the
run's device as one (n, h, w, c) float32 tensor in [-1, 1]; an epoch is a
pass over a permutation of it (``train/step.py`` ``EpochChunk``). Sources:

  - ``synthetic_digits``: procedural MNIST-scale images from a seed (numpy
    on a ``RandomState``, the JAX package's code, so both packages make the
    same corpus bitwise);
  - ``from_npz``: an (n, h, w[, c]) array from an .npz, with the JAX
    package's four ``pixel_range`` modes, its ``auto`` rules and their
    stderr notices, and the ``pixel_range`` metadata array;
  - ``from_folder``: every PNG/JPG of a directory, read with matplotlib's
    ``imread`` and resized with ``ops/images.py``'s ``resize_image``
    (``jax.image.resize``'s bilinear).

Flat vectors (``dimension``, ``sample``, ``plot_batch``) are in NHWC order,
as the JAX package's are. Random draws are counter-keyed (``ops/rng.py``):
``sample(seed, counter, n)`` takes its indices from the Philox words and
``epoch_permutation(seed, epoch)`` sorts one Philox key a position, so both
are the same on the CPU and the card. JAX's threefry draws are not
reproduced. There is no analytic oracle: ``score`` returns ``{}`` and the
engine skips scoring.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import rng


def _digit_image(rs: np.random.RandomState, size: int) -> np.ndarray:
    """One procedural 'digit-like' grayscale image in [-1, 1]: random strokes
    (lines/arcs) on an empty canvas (the JAX package's code, verbatim)."""
    img = np.zeros((size, size), np.float32)
    n_strokes = rs.randint(2, 5)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(n_strokes):
        kind = rs.randint(2)
        if kind == 0:  # line segment
            x0, y0, x1, y1 = rs.uniform(2, size - 2, 4)
            t = np.linspace(0, 1, 64)[:, None]
            px = x0 + (x1 - x0) * t
            py = y0 + (y1 - y0) * t
            d2 = (xx[None] - px[:, None]) ** 2 + (yy[None] - py[:, None]) ** 2
            img += np.exp(-d2.min(0) / 1.5)
        else:  # arc
            cx, cy = rs.uniform(4, size - 4, 2)
            r = rs.uniform(2, size / 3)
            a0 = rs.uniform(0, 2 * np.pi)
            a1 = a0 + rs.uniform(np.pi / 2, 2 * np.pi)
            t = np.linspace(a0, a1, 64)[:, None]
            px = cx + r * np.cos(t)
            py = cy + r * np.sin(t)
            d2 = (xx[None] - px[:, None]) ** 2 + (yy[None] - py[:, None]) ** 2
            img += np.exp(-d2.min(0) / 1.5)
    img = np.clip(img, 0, 1)
    return img * 2.0 - 1.0  # [-1, 1], the range img_tile expects


class ImageDataset:
    """A finite image corpus on one device, trained in epochs.

    ``images`` is (n, h, w, c) float32 in [-1, 1]; the flattened pixel
    count is the model's data dimension (the ELBO treats images as
    vectors)."""

    is_epochs = True

    def __init__(self, images, device="cpu"):
        images = torch.as_tensor(images, dtype=torch.float32)
        if images.ndim != 4:
            raise ValueError(f"images must be (n, h, w, c), got shape {tuple(images.shape)}")
        self.images = images.to(device).contiguous()

    # --- constructors -----------------------------------------------------
    @classmethod
    def synthetic_digits(cls, seed: int, n: int = 4096, size: int = 28,
                         device="cpu") -> "ImageDataset":
        """``n`` procedural size × size × 1 images from ``seed``."""
        rs = np.random.RandomState(seed)
        return cls(np.stack([_digit_image(rs, size) for _ in range(n)])[..., None],
                   device=device)

    @classmethod
    def from_npz(cls, path: str, key: str = "images", pixel_range: str = "auto",
                 device="cpu") -> "ImageDataset":
        """Load an (n, h, w[, c]) corpus from ``path``.

        ``pixel_range`` declares the source range: ``"0_255"`` remaps
        x/127.5 − 1, ``"0_1"`` remaps x·2 − 1, ``"pm1"`` passes through;
        ``"auto"`` (default) honours a ``pixel_range`` array in the npz,
        else guesses, announcing each guess on stderr: max > 1.5 ⇒ 0..255;
        all-nonnegative (integer {0, 1} corpora too) ⇒ [0, 1]; any negative
        value ⇒ already [-1, 1]."""
        data = np.load(path)
        arr = data[key].astype(np.float32)
        if arr.ndim == 3:
            arr = arr[..., None]
        if pixel_range == "auto" and "pixel_range" in getattr(data, "files", ()):
            pixel_range = str(np.asarray(data["pixel_range"]).item())
        if pixel_range == "auto":
            if arr.max() > 1.5:
                pixel_range = "0_255"
                print(f"[images] {path}: detected 0..255 range, remapping "
                      f"to [-1, 1] (x/127.5 - 1); pass pixel_range "
                      f"explicitly to override", file=sys.stderr, flush=True)
            elif arr.min() >= 0.0:
                pixel_range = "0_1"
                print(f"[images] {path}: all-nonnegative values — assuming "
                      f"[0, 1] and remapping to [-1, 1] (x*2 - 1); if the "
                      f"corpus is ALREADY [-1, 1], pass pixel_range='pm1' "
                      f"(or store a pixel_range='pm1' array in the npz)",
                      file=sys.stderr, flush=True)
            else:
                pixel_range = "pm1"
        if pixel_range in ("0_255", "255"):
            arr = arr / 127.5 - 1.0
        elif pixel_range in ("0_1", "01"):
            arr = arr * 2.0 - 1.0
        elif pixel_range not in ("pm1", "-1_1"):
            raise ValueError(f"unknown pixel_range {pixel_range!r}; expected "
                             f"auto | 0_255 | 0_1 | pm1")
        return cls(arr, device=device)

    @classmethod
    def from_folder(cls, path: str, size: Optional[int] = None,
                    device="cpu") -> "ImageDataset":
        """Load every PNG/JPG in a directory with matplotlib's ``imread``
        (an ImportError naming the package where it is not installed),
        resized to ``size`` × ``size`` where that differs."""
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError(f"--image_source {path}: reading an image folder needs "
                              f"matplotlib (its imread), which is not installed") from e
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..ops.images import resize_image

        files = sorted(f for f in os.listdir(path)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not files:
            raise ValueError(f"no images found in {path}")
        imgs = []
        for f in files:
            a = plt.imread(os.path.join(path, f)).astype(np.float32)
            if a.max() > 1.5:
                a = a / 255.0
            if a.ndim == 3 and a.shape[-1] == 4:
                a = a[..., :3]
            if a.ndim == 2:
                a = a[..., None]
            imgs.append(a * 2.0 - 1.0)
        arr = torch.as_tensor(np.stack(imgs))
        n, h, w, c = arr.shape
        if size is not None and (size != h or size != w):
            # one resize of the (h, w, n·c) stack: the same per image
            stack = resize_image(arr.permute(1, 2, 0, 3), (size, size))
            arr = stack.permute(2, 0, 1, 3)
        return cls(arr, device=device)

    # --- dataset interface --------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.images.device

    @property
    def n(self) -> int:
        return self.images.shape[0]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.images.shape[1:])

    @property
    def dimension(self) -> int:
        h, w, c = self.shape
        return h * w * c

    def sample(self, seed: int, counter, n: int, row0: int = 0) -> torch.Tensor:
        """(n, h·w·c) images drawn with replacement, flattened in NHWC
        order: image ``word % n_images`` for the first Philox word of each
        row at (counter, row, 0, STREAM_IMAGE_INDEX), rows from ``row0``."""
        w = rng.words(seed, counter, n, rng.STREAM_IMAGE_INDEX, 1, device=self.device,
                      row0=row0)
        return self.images.index_select(0, w[:, 0, 0] % self.n).reshape(n, -1)

    def epoch_permutation(self, seed: int, epoch: int) -> torch.Tensor:
        """The corpus order of epoch ``epoch`` (``rng.permutation``)."""
        return rng.permutation(seed, epoch, self.n, device=self.device)

    def score(self, batch) -> dict:
        # no analytic oracle; the engine skips scoring
        return {}

    def score_batch(self, batch) -> dict:
        return {}

    def plot_batch(self, batch, fn=None) -> bool:
        """The first 64 images tiled into one PNG (``ops/images.py``);
        False where matplotlib is not installed."""
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            return False
        from ..ops.images import img_tile

        b = torch.as_tensor(batch).detach().cpu()
        if b.ndim == 2:
            b = b.reshape(-1, *self.shape)
        if b.shape[-1] == 1:
            b = b[..., 0]
        img_tile(b[:64], fn, save=fn is not None)
        return True

    def host_copy(self) -> "ImageDataset":
        """The corpus on the host, for ``save`` in the background writer."""
        return self if self.images.device.type == "cpu" else ImageDataset(self.images.cpu())

    def save(self, fn: str) -> None:
        """``fn + ".npz"`` (np.savez's suffix), as the JAX corpus writes it;
        the pixel_range marker makes a save→load round trip exact."""
        np.savez(fn, images=self.images.cpu().numpy(), pixel_range="pm1")

    def load(self, fn: str) -> "ImageDataset":
        return ImageDataset.from_npz(fn if fn.endswith(".npz") else fn + ".npz",
                                     device=self.device)
