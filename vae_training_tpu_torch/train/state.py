"""Training state and the explicit Adam update, f32 or with bf16 moments.

Port of ``vae_training_tpu/train/state.py:18-117``. The Adam constants are
the reference's (flax.optim.Adam defaults) and the update is optax.adam's
formula, written out here rather than taken from ``torch.optim.Adam`` so
that the port owns its optimizer arithmetic (the CUDA kernels implement the
same update).

``--adam_dtype bf16`` (the JAX package's ``_scale_by_adam_bf16``, ``:48-97``)
stores the moments of every weight matrix in bfloat16 (``moment_dtype``):
each step computes m and v in float32 from the stored values, rounds them
to bfloat16 (round to nearest even), and feeds the ROUNDED values to the
parameter update. The kernels round at every step too, so a chunk of K
steps equals K single steps at every chunk boundary.

``TrainState`` holds everything a step mutates: parameters, the two Adam
moments (dicts keyed by the flax parameter names), the Adam step count, the
training step, and the two 64-bit run seeds that key the Philox streams
(``ops/rng.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Sequence

import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

Params = Dict[str, torch.Tensor]


def moment_dtype(shape: Sequence[int], adam_dtype: str) -> torch.dtype:
    """The dtype of a parameter's Adam moments: bfloat16 for a weight
    matrix (ndim ≥ 2) under ``adam_dtype="bf16"``; float32 otherwise, and
    always for biases, ``epsilon_p`` and ``epsilon``. The one place the
    rule lives (the JAX package's ``_moment_dtype``)."""
    if adam_dtype not in ("f32", "bf16"):
        raise ValueError(f"adam_dtype must be f32|bf16, got {adam_dtype!r}")
    return torch.bfloat16 if adam_dtype == "bf16" and len(shape) >= 2 else torch.float32


@dataclass
class TrainState:
    params: Params
    m: Params
    v: Params
    count: int  # Adam step count (optax ScaleByAdamState.count)
    step: int  # training step: the Philox counter's step word
    data_seed: int  # 64-bit key of the manifold / observation-noise streams
    model_seed: int  # 64-bit key of the z1 / z2 streams

    @classmethod
    def create(cls, params: Params, data_seed: int, model_seed: int,
               adam_dtype: str = "f32") -> "TrainState":
        params = {k: p.detach().clone() for k, p in params.items()}
        zeros = lambda: {  # noqa: E731
            k: torch.zeros_like(p, dtype=moment_dtype(p.shape, adam_dtype))
            for k, p in params.items()}
        return cls(params=params, m=zeros(), v=zeros(), count=0, step=0,
                   data_seed=data_seed, model_seed=model_seed)

    def to(self, device) -> "TrainState":
        move = lambda d: {k: t.to(device) for k, t in d.items()}  # noqa: E731
        return replace(self, params=move(self.params), m=move(self.m),
                       v=move(self.v))

    def host_copy(self) -> "TrainState":
        """A copy in host memory that later in-place updates do not reach
        (bfloat16 moments stay bfloat16): what the background writer saves."""
        copy = lambda d: {k: t.detach().to("cpu", copy=True) for k, t in d.items()}  # noqa: E731
        return replace(self, params=copy(self.params), m=copy(self.m), v=copy(self.v))

    @property
    def adam_dtype(self) -> str:
        """"bf16" when any moment is stored in bfloat16, else "f32"."""
        return "bf16" if any(t.dtype == torch.bfloat16 for t in self.m.values()) else "f32"


@torch.no_grad()
def adam_update_(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, count: int, lr: float) -> None:
    """One optax.adam step in place; ``count`` is the post-increment step:
    m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², p ← p − lr·m̂/(√v̂ + eps)
    with m̂ = m/(1−b1^count), v̂ = v/(1−b2^count).

    bfloat16 moments (``moment_dtype``): m and v are computed in float32
    from the stored values and rounded once, to nearest even, by the copy
    back; the update reads the rounded values. In-place ops on the bf16
    tensors would round after every op (and take (1−b1)·g in bf16)."""
    if m.dtype == torch.bfloat16:
        m.copy_(ADAM_B1 * m.float() + (1.0 - ADAM_B1) * g)
        v.copy_(ADAM_B2 * v.float() + (1.0 - ADAM_B2) * g * g)
        m32, v32 = m.float(), v.float()
    else:
        m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        m32, v32 = m, v
    m_hat = m32 / (1.0 - ADAM_B1 ** count)
    v_hat = v32 / (1.0 - ADAM_B2 ** count)
    p.sub_(lr * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS)))
