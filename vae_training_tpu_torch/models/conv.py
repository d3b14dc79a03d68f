"""The convolutional VAE for image corpora (BASELINE.json config 5).

Port of ``vae_training_tpu/models/conv.py``. The reference's VAE semantics
(``models/networks.py`` ``LatentVAE``: global ``epsilon_p``, the learned
scale of ε, output noise in both modes) with conv stacks: 3×3 stride-2
convolutions with ReLU, flatten, a dense posterior mean; a dense layer,
reshape, 3×3 stride-2 transposed convolutions back to the image. The ELBO
is over flattened pixels, in NHWC order.

Every parameter is stored under its flax name in flax's layout, so the
model.pkl name table (``runio/export.py``) stays a pure flatten: a conv
kernel is (kh, kw, in, out), permuted (and, for a transposed conv,
flipped) in ``forward``. Flax's conventions that differ from torch's:

  - ``nn.Conv(strides=2, padding="SAME")`` pads asymmetrically: for 28 → 14
    nothing before and one row after (``_same_pads``), not torch's one on
    each side;
  - ``nn.ConvTranspose`` (``transpose_kernel=False``) does not flip its
    kernel and, with "SAME" at stride 2, pads the dilated input (2, 1):
    that is ``conv_transpose2d`` with the kernel flipped and no padding,
    cropped to the first 2h × 2w outputs;
  - ``FCmu`` reads the encoder's output flattened in NHWC order, and
    ``FCin``'s output is reshaped to (B, h0, w0, C).

Kernels are initialised like flax's ``lecun_normal`` (fan-in 9·in for a
conv), biases to zero. ``bf16_dots`` (``--precision bf16`` on the card)
makes every conv, transposed conv and Dense product a bf16 dot
(``ops/precision.py``), the bias added after it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import precision
from .networks import Dense, LatentVAE, lecun_normal_, parse_layer_sizes

KSIZE, STRIDE = 3, 2


def _same_pads(n: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (before, after) of a 3×3 stride-2 window over
    ``n`` positions."""
    out = -(-n // STRIDE)
    total = max((out - 1) * STRIDE + KSIZE - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), strides=(2, 2))``: ``kernel``
    (3, 3, in, out), ``bias`` (out,); (B, C, H, W) in and out."""

    def __init__(self, in_features: int, out_features: int, bf16_dots: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(KSIZE, KSIZE, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.bf16_dots = bf16_dots

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, KSIZE * KSIZE * self.kernel.shape[2], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = _same_pads(x.shape[2]), _same_pads(x.shape[3])
        x = F.pad(x, (left, right, top, bottom))
        return precision.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias, self.bf16_dots,
                                stride=STRIDE)


class ConvTranspose(Conv):
    """flax ``nn.ConvTranspose(features, (3, 3), strides=(2, 2))``, "SAME":
    (B, C, h, w) → (B, out, 2h, 2w), the kernel (3, 3, in, out) unflipped."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        weight = self.kernel.flip(0, 1).permute(2, 3, 0, 1)  # (in, out, kh, kw)
        y = precision.conv_transpose2d(x, weight, self.bias, self.bf16_dots, stride=STRIDE)
        return y[:, :, :STRIDE * h, :STRIDE * w]


class ConvEncoder(nn.Module):
    """Strided conv stack → flatten (NHWC order) → dense posterior mean.
    Takes NHWC batches or their flat vectors."""

    def __init__(self, image_hwc: Tuple[int, int, int], latent_dim: int,
                 channels: Sequence[int], bf16_dots: bool = False):
        super().__init__()
        self.image_hwc = tuple(image_hwc)
        h, w, cin = self.image_hwc
        for i, ch in enumerate(channels):
            self.add_module(f"Conv{i}", Conv(cin, ch, bf16_dots))
            cin, h, w = ch, -(-h // STRIDE), -(-w // STRIDE)
        self.n_convs = len(channels)
        self.FCmu = Dense(h * w * cin, latent_dim, bf16_dots)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], *self.image_hwc).permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            x = torch.relu(getattr(self, f"Conv{i}")(x))
        return self.FCmu(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class ConvDecoder(nn.Module):
    """Dense → reshape → transposed-conv stack → image, flattened in NHWC
    order. ``channels`` are the encoder's, reversed."""

    def __init__(self, image_hwc: Tuple[int, int, int], latent_dim: int,
                 channels: Sequence[int], bf16_dots: bool = False):
        super().__init__()
        h, w, c = image_hwc
        n_up = len(channels)
        self.h0, self.w0, self.c0 = h // 2 ** n_up, w // 2 ** n_up, channels[0]
        self.FCin = Dense(latent_dim, self.h0 * self.w0 * self.c0, bf16_dots)
        for i in range(1, n_up):
            self.add_module(f"Up{i}", ConvTranspose(channels[i - 1], channels[i], bf16_dots))
        self.n_up = n_up
        self.UpOut = ConvTranspose(channels[-1], c, bf16_dots)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.FCin(z))
        x = x.reshape(z.shape[0], self.h0, self.w0, self.c0).permute(0, 3, 1, 2)
        for i in range(1, self.n_up):
            x = torch.relu(getattr(self, f"Up{i}")(x))
        x = self.UpOut(x)
        return x.permute(0, 2, 3, 1).reshape(z.shape[0], -1)


class ConvVAE(LatentVAE):
    """Conv VAE with the reference's latent and noise semantics; takes flat
    pixel batches (B, H·W·C) or NHWC batches (B, H, W, C)."""

    def __init__(self, *, image_hwc: Tuple[int, int, int], latent_dim: int,
                 channels: Tuple[int, ...] = (32, 64), epsilon: float = 0.0,
                 tunable_decoder_var: bool = False, bf16_dots: bool = False):
        super().__init__()
        h, w, c = image_hwc
        n_up = len(channels)
        if h % (2 ** n_up) or w % (2 ** n_up):
            raise ValueError(f"image size {h}x{w} must be divisible by 2^{n_up}")
        self.image_hwc = (h, w, c)
        self.channels = tuple(channels)
        self.bf16_dots = bf16_dots
        self.Encoder = ConvEncoder(self.image_hwc, latent_dim, self.channels, bf16_dots)
        self.Decoder = ConvDecoder(self.image_hwc, latent_dim, self.channels[::-1], bf16_dots)
        self._add_variances(latent_dim, epsilon, tunable_decoder_var)

    @property
    def data_dim(self) -> int:
        h, w, c = self.image_hwc
        return h * w * c

    def decode(self, samples: torch.Tensor) -> torch.Tensor:
        return self.Decoder(samples)


def build_conv_vae(*, image_hwc: Tuple[int, int, int], latent_dim: int,
                   channels_spec: str = "32|64", epsilon: float = 0.0,
                   tunable_decoder_var: bool = False, bf16_dots: bool = False) -> ConvVAE:
    """A ConvVAE from the CLI's ``--conv_channels`` (empty: 32|64);
    ``bf16_dots`` is the resolved ``--precision``."""
    channels = parse_layer_sizes(channels_spec) or (32, 64)
    return ConvVAE(image_hwc=tuple(image_hwc), latent_dim=latent_dim,
                   channels=tuple(channels), epsilon=epsilon,
                   tunable_decoder_var=tunable_decoder_var, bf16_dots=bf16_dots)
