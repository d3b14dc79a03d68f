"""Full training checkpoints with a working, bit-exact resume.

Port of ``vae_training_tpu/runio/checkpoint.py:103-260`` (the msgpack
backend) onto ``torch.save``. A checkpoint is the complete ``TrainState``
(params, Adam moments, counts, and both run seeds) as CPU tensors and
ints, so ``--resume <dir>`` continues bit-exactly: the Philox streams are
keyed by (seed, step), which the state carries. ``torch.save`` keeps each
tensor's dtype, so the bfloat16 moments of ``--adam_dtype bf16`` come back
with their bits; ``ckpt_meta.json`` records the run's ``adam_dtype``.

Kept from the reference implementation:
  - the trio ``ckpt.pt`` + ``ckpt_aux.pkl`` (host-side run state) +
    ``ckpt_meta.json`` (step, backend, extras), each written to a unique
    temporary name and renamed into place;
  - the meta step-ordering guard: a save never replaces a newer checkpoint;
  - one level of retention: a save that advances the step first sets the
    current trio aside under ``.prev``; restore falls back to it when a
    kill landed between the set-aside and the install;
  - the grid's roll-back (``train/grid.py``): ``prev=`` reads the retained
    trio, ``restore_checkpoint_prev`` restores it and
    ``promote_prev_checkpoint`` installs it as current.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import asdict
from typing import Optional

import torch

from ..train.state import TrainState

CKPT_NAME = "ckpt.pt"
META_NAME = "ckpt_meta.json"
AUX_NAME = "ckpt_aux.pkl"
PREV_SUFFIX = ".prev"
BACKEND = "torch"


def read_checkpoint_meta(dirname: str, prev: bool = False) -> Optional[dict]:
    """The checkpoint's metadata (step, backend, extras), or None;
    ``prev=True`` reads the retained previous save's."""
    try:
        with open(os.path.join(dirname, META_NAME + (PREV_SUFFIX if prev else ""))) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def restore_checkpoint_aux(dirname: str, prev: bool = False) -> Optional[dict]:
    """The host-side run state saved beside the checkpoint, or None;
    ``prev=True`` reads the retained previous save's."""
    try:
        with open(os.path.join(dirname, AUX_NAME + (PREV_SUFFIX if prev else "")), "rb") as f:
            return pickle.load(f)
    except OSError:
        return None


def _state_payload(state: TrainState) -> dict:
    payload = asdict(state)
    for k in ("params", "m", "v"):
        payload[k] = {n: t.detach().cpu() for n, t in payload[k].items()}
    return payload


def save_checkpoint(dirname: str, state: TrainState,
                    extra_meta: Optional[dict] = None,
                    aux: Optional[dict] = None) -> str:
    payload = _state_payload(state)
    meta = {"step": int(state.step), "backend": BACKEND, "adam_dtype": state.adam_dtype}
    if extra_meta:
        meta.update(extra_meta)
    path = os.path.join(dirname, CKPT_NAME)
    aux_path = os.path.join(dirname, AUX_NAME)
    meta_path = os.path.join(dirname, META_NAME)
    suffix = f".tmp.{os.getpid()}"
    cur = read_checkpoint_meta(dirname)
    if cur is not None and cur.get("step", -1) > meta["step"]:
        return path  # never replace a newer checkpoint with an older one
    # stage everything, then retain, then install (meta last: it is the
    # ordering authority)
    tmp = path + suffix
    torch.save(payload, tmp)
    atmp = None
    if aux is not None:
        atmp = aux_path + suffix
        with open(atmp, "wb") as f:
            pickle.dump({**aux, "step": meta["step"]}, f)
    mtmp = meta_path + suffix
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    if cur is not None and cur.get("step", -1) < meta["step"]:
        for p in (path, aux_path, meta_path):
            if os.path.exists(p):
                os.replace(p, p + PREV_SUFFIX)
    os.replace(tmp, path)
    if atmp is not None:
        os.replace(atmp, aux_path)
    os.replace(mtmp, meta_path)
    return path


def checkpoint_exists(dirname: str) -> bool:
    path = os.path.join(dirname, CKPT_NAME)
    return os.path.exists(path) or os.path.exists(path + PREV_SUFFIX)


def restore_checkpoint(dirname: str, device="cpu") -> TrainState:
    """The newest checkpoint in ``dirname`` as a TrainState on ``device``."""
    path = os.path.join(dirname, CKPT_NAME)
    if not os.path.exists(path) and os.path.exists(path + PREV_SUFFIX):
        # killed between the retention set-aside and the install
        path += PREV_SUFFIX
    return _load(path, device)


def restore_checkpoint_prev(dirname: str, device="cpu") -> TrainState:
    """The retained previous checkpoint (the save before the newest) as a
    TrainState on ``device``; OSError if there is none. The grid's roll-back
    of a row that saved one event ahead of the others."""
    return _load(os.path.join(dirname, CKPT_NAME + PREV_SUFFIX), device)


def promote_prev_checkpoint(dirname: str) -> None:
    """Install the retained ``.prev`` trio as the current checkpoint and
    drop the newer save (the grid's roll-back: left in place, the newer
    meta step would make the step guard refuse every later save). Meta
    first, as it is the ordering authority: a kill mid-promotion leaves
    what the next restore rolls back again."""
    for name in (META_NAME, AUX_NAME, CKPT_NAME):
        path = os.path.join(dirname, name)
        if os.path.exists(path + PREV_SUFFIX):
            os.replace(path + PREV_SUFFIX, path)


def _load(path: str, device) -> TrainState:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return TrainState(**payload).to(device)
