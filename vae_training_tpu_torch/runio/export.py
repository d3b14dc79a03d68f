"""model.pkl in the reference's optimizer-state-dict layout, and the
weight converter between the two packages.

Port of ``vae_training_tpu/runio/export.py:51-109``. A ``model.pkl`` is

    {"target": {"Encoder": {"FC0": {"kernel", "bias"}}, "Decoder": ...,
                "epsilon_p", "epsilon"},
     "state": {"step": <Adam count>,
               "param_states": <the same tree, each leaf
                                {"grad_ema": m, "grad_sq_ema": v}>}}

with numpy leaves, so a file written by either package loads in the other.
``state_from_flax`` and ``from_reference_state_dict`` turn the JAX
package's parameters and Adam state (numpy, flax names) into the port's
tensors; the port keeps the flax names and (in, out) layouts, so the
conversion only flattens the tree into dotted names.

Under ``--adam_dtype bf16`` the port writes its bfloat16 moments as float32
arrays holding the same values (exact): numpy has no bfloat16 of its own,
and the JAX package's ``ml_dtypes.bfloat16`` arrays
(``vae_training_tpu/runio/export.py:54``) need a package the port does not
depend on. So ``load_model_pkl`` of the port's file gives float32 moments,
and it reads a JAX bf16 run's file without ``ml_dtypes``: its unpickler
takes the ``ml_dtypes.bfloat16`` dtype as ``numpy.uint16``, which loads the
same 16-bit patterns, and ``state_from_flax`` turns them into bfloat16
tensors of the same bits.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from ..train.state import TrainState


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if hasattr(v, "items"):  # dict or flax FrozenDict
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def flax_keys(name: str) -> tuple:
    """A port parameter name → its path in the flax tree:
    ``"Decoder.FC0.kernel"`` → ``("Decoder", "FC0", "kernel")``. The one
    name table between the two packages: the model.pkl layout and the
    per-parameter ``Correlation Ratio/<path>`` keys (``utils/trees.py``)
    both go through it."""
    return tuple(name.split("."))


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = flax_keys(name)
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _to_numpy(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """float32 numpy copies (a bfloat16 moment's values, exactly)."""
    return {k: t.detach().cpu().float().numpy().copy() for k, t in d.items()}


def to_reference_state_dict(state: TrainState) -> dict:
    params, m, v = (_to_numpy(d) for d in (state.params, state.m, state.v))
    param_states = {k: {"grad_ema": m[k], "grad_sq_ema": v[k]} for k in params}
    return {"target": _unflatten(params),
            "state": {"step": int(state.count),
                      "param_states": _unflatten(param_states)}}


def _flatten_states(tree, prefix: str = "") -> Dict[str, dict]:
    out = {}
    for k, val in tree.items():
        if "grad_ema" in val:
            out[f"{prefix}{k}"] = val
        else:
            out.update(_flatten_states(val, f"{prefix}{k}."))
    return out


def state_from_flax(params_np, mu_np, nu_np, count: int, *, data_seed: int = 0,
                    model_seed: int = 0) -> TrainState:
    """The JAX package's params and optax Adam moments (nested numpy trees
    with flax names) → a port TrainState computing the same thing (at step
    ``count``; the run seeds are the caller's). Leaves are float32 (float64
    is narrowed), or bfloat16: the JAX package's ``--adam_dtype bf16``
    moments, either as ``ml_dtypes.bfloat16`` arrays or as the ``uint16``
    bit patterns ``load_model_pkl`` reads them as (a model.pkl has no other
    16-bit leaves). Both become bfloat16 tensors of the same bits. Any other
    dtype raises."""

    def tensor(a):
        if a.dtype.name in ("bfloat16", "uint16"):
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        if a.dtype not in (np.float32, np.float64):
            raise TypeError(f"model state leaf of dtype {a.dtype}: expected float32, "
                            f"or bfloat16 moments (uint16 bit patterns)")
        return torch.tensor(np.asarray(a, np.float32))

    flat = lambda tree: {k: tensor(a) for k, a in _flatten(tree).items()}  # noqa: E731
    return TrainState(params=flat(params_np), m=flat(mu_np), v=flat(nu_np),
                      count=int(count), step=int(count), data_seed=data_seed,
                      model_seed=model_seed)


def from_reference_state_dict(sd: dict, **seeds) -> TrainState:
    """A reference-layout state dict (either package's ``model.pkl``) → a
    port TrainState."""
    target = sd["target"]
    if set(target) == {"params"}:
        target = target["params"]  # the JAX package's pre-round-2 exports
    states = _flatten_states(sd["state"]["param_states"])
    mu = _unflatten({k: v["grad_ema"] for k, v in states.items()})
    nu = _unflatten({k: v["grad_sq_ema"] for k, v in states.items()})
    return state_from_flax(target, mu, nu, sd["state"]["step"], **seeds)


def save_model_pkl(path: str, state: TrainState) -> None:
    with open(path, "wb") as f:
        pickle.dump(to_reference_state_dict(state), f)


class _Unpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that needs no ``ml_dtypes``: the dtype of a JAX
    bf16 run's moments, ``numpy.dtype(ml_dtypes.bfloat16)``, loads as
    ``numpy.dtype(numpy.uint16)``, so those arrays keep their 16-bit
    patterns (bfloat16 and uint16 are both two bytes, little-endian)."""

    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return np.uint16
        return super().find_class(module, name)


def load_model_pkl(path: str) -> TrainState:
    """A model.pkl written by either package, as a port TrainState; a JAX
    ``--adam_dtype bf16`` run's bfloat16 moments load bit for bit, with or
    without ``ml_dtypes`` installed."""
    with open(path, "rb") as f:
        sd = _Unpickler(f).load()
    return from_reference_state_dict(sd)
