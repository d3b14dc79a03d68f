"""Parameter-tree math over the port's parameter dicts.

Port of ``vae_training_tpu/utils/trees.py``. A tree here is a dict from
the port's dotted parameter names (``Decoder.FC0.kernel``) to tensors or
numpy arrays; its leaves are visited in the JAX package's order (each
name's flax path, ``runio/export.py:flax_keys``, sorted), so the sums run
in the same order. ``correlation_ratio`` is the reference's landscape
diagnostic,

    ratio = -⟨∇loss(θ), θ* − θ⟩ / ‖θ* − θ‖²,

how well the negative gradient at θ points toward the final parameters
θ*; ``--track_correlation`` records it (``train/loop.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..runio.export import flax_keys


def _leaves(tree: dict):
    """(name, float32 CPU tensor) in the JAX package's leaf order."""
    for name in sorted(tree, key=flax_keys):
        yield name, torch.as_tensor(tree[name]).detach().to("cpu", torch.float32)


def tree_vdot(a: dict, b: dict) -> torch.Tensor:
    """Σ over leaves of ⟨a_leaf, b_leaf⟩, in float32."""
    flat_b = dict(_leaves(b))
    total = torch.zeros((), dtype=torch.float32)
    for name, x in _leaves(a):
        total = total + torch.vdot(x.reshape(-1), flat_b[name].reshape(-1))
    return total


def tree_sq_norm(a: dict) -> torch.Tensor:
    return tree_vdot(a, a)


def _displacement(opt_params: dict, params: dict) -> Dict[str, torch.Tensor]:
    flat_p = dict(_leaves(params))
    return {name: o - flat_p[name] for name, o in _leaves(opt_params)}


def correlation_ratio(opt_params: dict, params: dict, grads: dict) -> torch.Tensor:
    """Whole-tree ratio: the per-leaf inner products and squared norms are
    summed before the one division, as the reference accumulates them."""
    d = _displacement(opt_params, params)
    return -tree_vdot(grads, d) / tree_sq_norm(d)


def correlation_ratio_per_param(opt_params: dict, params: dict, grads: dict
                                ) -> Dict[str, torch.Tensor]:
    """One ratio a leaf, keyed by its flax path joined by slashes
    (``Decoder/FC0/kernel``), the JAX package's keys. A leaf that did not
    move gives NaN (0/0), as the formula does."""
    flat_g = dict(_leaves(grads))
    out = {}
    for name, d in _displacement(opt_params, params).items():
        d, g = d.reshape(-1), flat_g[name].reshape(-1)
        out["/".join(flax_keys(name))] = -torch.vdot(g, d) / torch.vdot(d, d)
    return out


def sin_theta_distance(A, B) -> torch.Tensor:
    """Sin-theta distance between the column spaces of A and B (the
    reference assumes orthogonal inputs). The SVDs run in numpy on the
    host, as in the JAX package; the distance comes back as float32, as
    the JAX package's does."""
    U, _, _ = np.linalg.svd(np.asarray(torch.as_tensor(A).detach().cpu()))
    Up, _, _ = np.linalg.svd(np.asarray(torch.as_tensor(B).detach().cpu()))
    return torch.tensor(0.5 * np.linalg.norm(U - Up, ord="fro"), dtype=torch.float32)
