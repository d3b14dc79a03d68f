"""The port's single noise definition: counter-based Philox4x32-10.

Counterpart of the JAX package's ``jax.random`` uses (``fold_in(key,
step)`` streams) and of the fused kernel's in-kernel sampler
(``vae_training_tpu/kernels/linear_vae.py:134-158``). Every random number the
training path draws is a pure function of

    key     = a 64-bit run seed (two 32-bit words, low word first)
    counter = (absolute step, row, draw index, stream id)

so the streams do not depend on how steps are grouped into chunks, and a
resumed run draws exactly what an uninterrupted one draws. The CUDA kernel
(``csrc/linear_vae.cu``) evaluates the same function; ``chip_smoke.py``
holds its words bitwise against this module.

One Philox call yields four 32-bit words. A uniform is
``((word >> 8) + 0.5) * 2**-24``, computed in float32 exactly as the TPU
kernel's ``_uniform``: never 0, so the Box-Muller log is finite (the top
24-bit value rounds to exactly 1.0, which gives a radius of 0). Words
(0, 1) and (2, 3) each feed one Box-Muller cos/sin pair, so draw ``j`` of
a row supplies normals ``4j .. 4j+3`` of that row's stream.

Words are carried in int64 tensors holding values in [0, 2**32). A 32x32-bit
product does not fit a signed int64, so ``_mulhilo`` splits one factor into
16-bit halves.
"""

from __future__ import annotations

import math

import torch

# Random123's Philox4x32 constants.
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
TWO_PI = 2.0 * math.pi
INV_2_24 = 1.0 / 16777216.0

# Stream ids (the counter's last word). The data key feeds the manifold
# sample and its observation noise; the model key feeds z1 and z2.
STREAM_MANIFOLD = 0  # intrinsic normals n, x = n·Aᵀ
STREAM_Z1 = 1  # reparameterisation noise (latent_dim per row)
STREAM_Z2 = 2  # decoder output noise (data_dim per row)
STREAM_OBS = 3  # observation noise of variance var_added (data_dim per row)
STREAM_IMAGE_INDEX = 4  # an image corpus's random subset (one word per row)
STREAM_PERMUTATION = 5  # an image corpus's epoch permutation (one draw per image)

# Purposes for derive_seed: the run seeds that key each stream family.
SEED_TRAIN_DATA = 1  # per-step training batches (JAX: fold_in(data_root, 1))
SEED_EVAL_DATA = 2  # eval / banner real batches (JAX: fold_in(data_root, 2))
SEED_TRAIN_Z = 3  # per-step z1/z2
SEED_EVAL_Z = 4  # eval-time prior draws
SEED_PLOT_Z = 5  # plot-time prior draws
SEED_WARM_START = 6  # -ws perturbation draws (models/warm_start.py)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and the word tensor ``b``, without overflowing int64."""
    p_lo = (a & 0xFFFF) * b  # < 2**48
    p_hi = (a >> 16) * b  # < 2**48
    mid = p_hi + (p_lo >> 16)  # product = mid·2**16 + (p_lo & 0xFFFF)
    hi = mid >> 16
    lo = ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on broadcastable int64 word tensors; returns the four
    output words as int64 tensors in [0, 2**32)."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def key_words(seed: int):
    """64-bit run seed → (k0, k1), low word first."""
    seed &= MASK64
    return seed & MASK32, seed >> 32


def derive_seed(seed: int, purpose: int) -> int:
    """A 64-bit run seed for one stream family, from a CLI seed: the first
    two words of Philox with key (seed, 0) at counter (0, 0, 0, purpose)."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    w = philox4x32(t(0), t(0), t(0), t(purpose), *key_words(seed))
    return int(w[0]) | (int(w[1]) << 32)


def words(seed: int, step, rows: int, stream: int, n_draws: int,
          device=None, row0: int = 0) -> torch.Tensor:
    """(rows, n_draws, 4) int64 Philox words at counters
    (step, row, draw, stream) for every row0 <= row < row0 + rows and
    draw < n_draws. ``row0`` is a data-parallel rank's first row of the
    global batch (``parallel/dp.py``): its rows are those rows of the
    one-device draw, bit for bit.

    ``step`` is a Python int or a device int64 tensor holding the absolute
    step (the CUDA-graph chunk's counter, ``train/step.py``): the counter
    word is its low 32 bits either way, taken on the device for a tensor,
    so the two forms give the same words and a captured graph reads the
    step at replay time."""
    i64 = dict(dtype=torch.int64, device=device)
    if isinstance(step, torch.Tensor):
        c0 = step.to(torch.int64) & MASK32
    else:
        c0 = torch.full((), step & MASK32, **i64)
    c1 = torch.arange(row0, row0 + rows, **i64).view(rows, 1)
    c2 = torch.arange(n_draws, **i64).view(1, n_draws)
    c3 = torch.full((), stream, **i64)
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    out = philox4x32(c0, c1, c2, c3, *key_words(seed))
    return torch.stack(out, dim=-1)


def widen(w32: torch.Tensor) -> torch.Tensor:
    """int32 tensors of word bits (a CUDA kernel's uint32 words) → the int64
    values in [0, 2**32) this module carries."""
    return w32.to(torch.int64) & MASK32


def narrow(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) → int32 tensors of the same bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def uniforms(w: torch.Tensor) -> torch.Tensor:
    """Words → float32 uniforms ((w >> 8) + 0.5)·2**-24 in (0, 1]."""
    return ((w >> 8).to(torch.float32) + 0.5) * INV_2_24


def box_muller(w: torch.Tensor) -> torch.Tensor:
    """(..., 4) words → (..., 4) normals: [r₀cosθ₀, r₀sinθ₀, r₁cosθ₁, r₁sinθ₁]
    with uniforms (u₀, θ₀/2π) from words (0, 1) and (u₁, θ₁/2π) from (2, 3)."""
    u = uniforms(w)
    r = torch.sqrt(-2.0 * torch.log(u[..., 0::2]))
    theta = TWO_PI * u[..., 1::2]
    pairs = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return pairs.flatten(-2)


def normals(seed: int, step, rows: int, stream: int, dim: int,
            device=None, row0: int = 0) -> torch.Tensor:
    """(rows, dim) float32 standard normals of one stream at one step
    (``step`` an int or a device int64 tensor, ``row0`` the first row, as
    in ``words``)."""
    n_draws = (dim + 3) // 4
    w = words(seed, step, rows, stream, n_draws, device=device, row0=row0)
    return box_muller(w).reshape(rows, 4 * n_draws)[:, :dim]


def permutation(seed: int, counter: int, n: int, device=None) -> torch.Tensor:
    """A permutation of ``range(n)`` (int64) keyed by ``seed`` at
    ``counter``: the stable argsort of one 63-bit key a position, made
    from words 0 and 1 of the Philox draw at (counter, position, 0,
    STREAM_PERMUTATION). Integer work only, so it is the same on every
    device; a repeated key (odds about n² / 2**64) keeps position order."""
    w = words(seed, counter, n, STREAM_PERMUTATION, 1, device=device)[:, 0]
    keys = (w[:, 0] << 31) | (w[:, 1] >> 1)
    return torch.argsort(keys, stable=True)
