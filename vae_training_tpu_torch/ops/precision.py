"""bfloat16-operand dots with f32 sums: ``--precision bf16`` on the card.

Counterpart of ``vae_training_tpu/models/networks.py:34``
(``to_dot_precision``): on its accelerator the JAX package's default f32 dot
feeds the matrix unit operands rounded to bfloat16 (round to nearest even)
and sums the exact products in f32 (``tools/check_precision.py:50-51``).
Every layer applies it to three dots: the forward ``x·W``, the input
gradient ``g·Wᵀ`` (g and W rounded) and the weight gradient ``xᵀ·g`` (x and
g rounded). A bias is added after the dot and its gradient is a plain sum,
so neither is rounded.

Two autograd functions give exactly those three dots from one product:

  - ``round_operand``: forward rounds to bfloat16 and back to float32,
    backward is the identity;
  - ``round_grad``: forward is the identity, backward rounds the cotangent.

``dot(a, b, True)`` is ``round_grad(round_operand(a) @ round_operand(b))``;
a layer adds its bias after it. Everything here is elementwise, so a CUDA
graph captures it and a graph replay equals the op-by-op run bitwise. The
product itself is an fp32 GEMM (TF32 off, ``config.use_fp32_math``), which
is exact for the products of bfloat16 values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bfloat16 (ties to even), as float32; no
    autograd (data, noise and the samplers' operands)."""
    return t.to(torch.bfloat16).to(t.dtype)


class _RoundOperand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return bf16_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return bf16_round(g)


def round_operand(x: torch.Tensor) -> torch.Tensor:
    """A dot operand: rounded to bfloat16 going forward, its gradient
    passed through unchanged."""
    return _RoundOperand.apply(x)


def round_grad(y: torch.Tensor) -> torch.Tensor:
    """A dot's result: unchanged going forward, its cotangent rounded to
    bfloat16 going back (the gradient dots' operand)."""
    return _RoundGrad.apply(y)


def dot(a: torch.Tensor, b: torch.Tensor, bf16_dots: bool) -> torch.Tensor:
    """``a @ b``; with ``bf16_dots`` the reference's bf16 dot in both
    directions (operands rounded forward, the cotangent rounded back)."""
    if not bf16_dots:
        return a @ b
    return round_grad(round_operand(a) @ round_operand(b))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, bf16_dots: bool,
           **kwargs) -> torch.Tensor:
    """``F.conv2d`` with its bias; with ``bf16_dots`` the conv of rounded
    operands, its cotangent rounded, the bias added after (so its gradient
    sums unrounded cotangents, as a Dense bias's does)."""
    if not bf16_dots:
        return F.conv2d(x, weight, bias, **kwargs)
    y = round_grad(F.conv2d(round_operand(x), round_operand(weight), None, **kwargs))
    return y + bias[:, None, None]


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     bf16_dots: bool, **kwargs) -> torch.Tensor:
    """``F.conv_transpose2d`` with its bias, in the same two modes as
    ``conv2d``."""
    if not bf16_dots:
        return F.conv_transpose2d(x, weight, bias, **kwargs)
    y = round_grad(F.conv_transpose2d(round_operand(x), round_operand(weight), None, **kwargs))
    return y + bias[:, None, None]
