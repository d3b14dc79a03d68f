"""Invertible-flow building blocks, the reference's library surface.

Port of ``vae_training_tpu/ops/flows.py``: an invertible BatchNorm that
records the affine map it applied so that the map can be inverted, its
inverse, the inverse of a dense layer, the leaky ReLU pair, coupling-layer
masks, 2×2 space-to-depth and two classifier helpers. The live VAE path
uses none of them. ``InvertibleBatchNorm`` keeps the flax module's
``batch_stats`` collection as buffers (``mean``, ``var``, ``recent_mul``,
``recent_mean``) and its parameters as ``scale`` and ``bias``; its
``process_group`` is the JAX module's ``axis_name`` and
``axis_index_groups``: the batch moments are averaged over the group's
ranks (one all-reduce of ``[mean, mean2]``, with autograd), as
``lax.pmean`` averages them over a mesh axis.
"""

from __future__ import annotations

import torch
from torch import nn


class Constants:
    """Hyperparameter constants of the reference."""

    lambd = 10
    alpha = 0.1
    epsilon_singular_value = 1e-7


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, x * Constants.alpha)


def inv_leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(x, x / Constants.alpha)


def inv_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Invert y = x·W + b."""
    return (x - bias) @ torch.linalg.inv(weight)


class InvertibleBatchNorm(nn.Module):
    """BatchNorm over every axis but ``axis`` that records the exact
    (mul, mean) of each call, so that ``inv_batch_norm`` can invert it.

    ``num_features`` is the size of ``axis``. In training mode (the
    default, ``use_running_average=False``) the batch moments normalise the
    input and move the running averages by ``momentum``; ``recent_mul`` and
    ``recent_mean`` record the call's rsqrt(var + ε) and mean.

    With ``process_group`` (``torch.distributed``) the batch moments are
    the means over the group's ranks of each rank's moments: equal local
    batches give the moments of the whole batch. The all-reduce carries
    autograd (its backward all-reduces the gradient), so every rank's
    gradients are those of the sum of the ranks' losses. The flax module
    skips the mean while it initialises; this module's initialisation runs
    no forward, so every call takes it."""

    def __init__(self, num_features: int, axis: int = -1, momentum: float = 0.99,
                 epsilon: float = 1e-5, use_bias: bool = True, use_scale: bool = True,
                 process_group=None):
        super().__init__()
        self.axis, self.momentum, self.epsilon = axis, momentum, epsilon
        self.process_group = process_group
        self.use_bias, self.use_scale = use_bias, use_scale
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.register_buffer("recent_mul", torch.ones(num_features))
        # the mean as the input broadcasts it, shaped at the first call
        self.register_buffer("recent_mean", torch.zeros(num_features))
        if use_scale:
            self.scale = nn.Parameter(torch.ones(num_features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, use_running_average: bool = False) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        feat = self.axis % x.ndim
        feature_shape = tuple(d if i == feat else 1 for i, d in enumerate(x.shape))
        reduction = tuple(i for i in range(x.ndim) if i != feat)
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean = torch.mean(x, dim=reduction)
            mean2 = torch.mean(torch.square(x), dim=reduction)
            if self.process_group is not None:
                import torch.distributed as dist
                from torch.distributed.nn.functional import all_reduce

                stacked = all_reduce(torch.cat([mean, mean2]), group=self.process_group)
                stacked = stacked / dist.get_world_size(self.process_group)
                mean, mean2 = torch.split(stacked, mean.shape[0])
            var = mean2 - torch.square(mean)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        mean_b = mean.reshape(feature_shape)
        y = x - mean_b
        mul = torch.rsqrt(var + self.epsilon)
        with torch.no_grad():
            self.recent_mean = mean_b.detach().clone()
            self.recent_mul.copy_(mul)
        mul_b = mul.reshape(feature_shape)
        if self.use_scale:
            mul_b = mul_b * self.scale.reshape(feature_shape)
        y = y * mul_b
        if self.use_bias:
            y = y + self.bias.reshape(feature_shape)
        return y


def inv_batch_norm(y: torch.Tensor, params, batch_stats, use_bias: bool = True,
                   use_scale: bool = True) -> torch.Tensor:
    """Invert an ``InvertibleBatchNorm`` call from its parameters
    (``scale``, ``bias``) and its recorded stats (``recent_mul``,
    ``recent_mean``): ``dict(bn.named_parameters())`` and
    ``dict(bn.named_buffers())``, as the JAX function takes the flax
    module's ``params`` and ``batch_stats``."""
    mul = batch_stats["recent_mul"]
    mean = batch_stats["recent_mean"]
    if use_bias:
        y = y - params["bias"]
    y = y / mul
    if use_scale:
        y = y / params["scale"]
    return y + mean


def get_mask(shape, reverse: bool, use_checkerboard: bool = True) -> torch.Tensor:
    """Coupling-layer masks, checkerboard (H, W, 1) or channel split
    (H, W, C), for ``shape`` (H, W, C) or (B, H, W, C) (then with a
    leading axis of 1)."""
    height, width, channels = shape[-3], shape[-2], shape[-1]
    if use_checkerboard:
        rows = torch.arange(height).view(height, 1)
        cols = torch.arange(width).view(1, width)
        mask = ((rows % 2 + cols) % 2).to(torch.float32).reshape(height, width, 1)
        if reverse:
            mask = 1.0 - mask
    else:
        half = channels // 2
        zero = torch.zeros((height, width, half))
        one = torch.ones((height, width, half))
        mask = torch.cat([zero, one] if reverse else [one, zero], dim=-1)
    if len(shape) == 4:
        return mask[None]
    return mask


def squeeze_2x2(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """2×2 space-to-depth on (B, H, W, C), and its inverse."""
    if x.ndim != 4:
        raise ValueError("expected (B, H, W, C)")
    b, h, w, c = x.shape
    if reverse:
        if c % 4 != 0:
            raise ValueError(f"Number of channels {c} is not divisible by 4")
        x = x.reshape(b, h, w, c // 4, 2, 2)
        x = x.permute(0, 1, 4, 2, 5, 3)
        return x.reshape(b, 2 * h, 2 * w, c // 4)
    if h % 2 != 0 or w % 2 != 0:
        raise ValueError(f"Expected even spatial dims HxW got {h}x{w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per example, minus the logit of its label (the reference's form)."""
    return -torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)


def compute_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
