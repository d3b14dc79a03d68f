"""Training state and the explicit f32 Adam update.

Port of ``vae_training_tpu/train/state.py:18-117``. The Adam constants are
the reference's (flax.optim.Adam defaults) and the update is optax.adam's
formula, written out here rather than taken from ``torch.optim.Adam`` so
that the port owns its optimizer arithmetic (the CUDA kernel implements the
same update, and the bf16-moment variant will extend this one).

``TrainState`` holds everything a step mutates: parameters, the two Adam
moments (dicts keyed by the flax parameter names), the Adam step count, the
training step, and the two 64-bit run seeds that key the Philox streams
(``ops/rng.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

Params = Dict[str, torch.Tensor]


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
    def create(cls, params: Params, data_seed: int, model_seed: int) -> "TrainState":
        params = {k: p.detach().clone() for k, p in params.items()}
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return cls(params=params, m=zeros(), v=zeros(), count=0, step=0,
                   data_seed=data_seed, model_seed=model_seed)

    def to(self, device) -> "TrainState":
        move = lambda d: {k: t.to(device) for k, t in d.items()}  # noqa: E731
        return replace(self, params=move(self.params), m=move(self.m),
                       v=move(self.v))


@torch.no_grad()
def adam_update_(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, count: int, lr: float) -> None:
    """One optax.adam step in place; ``count`` is the post-increment step:
    m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², p ← p − lr·m̂/(√v̂ + eps)
    with m̂ = m/(1−b1^count), v̂ = v/(1−b2^count)."""
    m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
    v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
    m_hat = m / (1.0 - ADAM_B1 ** count)
    v_hat = v / (1.0 - ADAM_B2 ** count)
    p.sub_(lr * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS)))
