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

Beyond it: a run's ``--resume`` reads ``restore_run``, the newest save
whose state, aux and meta all match, where the JAX engine pairs the newest
state with the current aux and falls back to a state-only resume; a kill
between two renames of a save (a supervised sweep row's deadline) then
still resumes bitwise.

``--ckpt_backend orbax`` (the JAX package's ``runio/checkpoint.py:269-341``):
the JAX world's standard directory checkpoint is orbax's; the PyTorch
world's is ``torch.distributed.checkpoint`` (DCP), so on the port that
flag writes a DCP directory, ``dcp_ckpt/`` (``DCP_NAME``), and the meta's
``backend`` reads ``"dcp"`` (``DCP_BACKEND``). The directory holds the
TrainState flat, one entry a tensor (``params/<name>``, ``m/<name>``,
``v/<name>``, each with its dtype) and the ints as DCP's byte entries, so
a restore needs no template: the shapes and dtypes come from the
directory's own metadata. It is written with ``no_dist=True``: a
primary-only save never enters a collective, whatever process group the
run has. What the JAX orbax backend guarantees, it keeps:
  - the step-ordering guard on the shared meta: a queued save never
    replaces a newer checkpoint of either backend;
  - the directory swap: the new checkpoint is written to ``dcp_ckpt.new``,
    the old one set aside as ``dcp_ckpt.old``, the new one installed, then
    the old one deleted; a save that finds only ``.old`` (a kill mid-swap)
    promotes it back first and never deletes it. A kill at any point leaves
    a complete checkpoint;
  - the aux, then the meta, last; the old aux and meta are set aside under
    ``.prev`` first and ``.old`` is deleted only after the new meta, so
    that a kill at any rename leaves a complete save, state, aux and meta,
    for ``restore_run``;
  - ``restore_checkpoint`` follows the meta's ``backend`` and falls back to
    whichever checkpoint exists; ``checkpoint_exists`` counts the directory
    and its ``.old``.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import warnings
from dataclasses import asdict
from typing import Optional

import torch

from ..train.state import TrainState

CKPT_NAME = "ckpt.pt"
META_NAME = "ckpt_meta.json"
AUX_NAME = "ckpt_aux.pkl"
PREV_SUFFIX = ".prev"
BACKEND = "torch"
DCP_NAME = "dcp_ckpt"
DCP_BACKEND = "dcp"


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
    return (os.path.exists(path) or os.path.exists(path + PREV_SUFFIX)
            or _dcp_dir(dirname) is not None)


def restore_checkpoint(dirname: str, device="cpu") -> TrainState:
    """The newest checkpoint in ``dirname`` as a TrainState on ``device``.
    Both backends write the shared meta under the step-ordering guard, so
    its ``backend`` names the checkpoint that holds the newest state: a
    stale torch.save checkpoint never shadows a newer DCP one, nor the
    reverse."""
    path = os.path.join(dirname, CKPT_NAME)
    dcp_dir = _dcp_dir(dirname)
    backend = (read_checkpoint_meta(dirname) or {}).get("backend")
    if dcp_dir is not None and (backend == DCP_BACKEND or not os.path.exists(path)):
        return _load_dcp(dcp_dir, device)
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


def save_checkpoint_dcp(dirname: str, state: TrainState,
                        extra_meta: Optional[dict] = None,
                        aux: Optional[dict] = None) -> str:
    """The DCP backend's save (``--ckpt_backend orbax``): the directory
    swap, then the aux, then the meta."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(os.path.join(dirname, DCP_NAME))
    new, old = path + ".new", path + ".old"
    step = int(state.step)
    cur = read_checkpoint_meta(dirname)
    if cur is not None and cur.get("step", -1) > step:
        return path  # never replace a newer checkpoint (of either backend)
    if os.path.exists(new):
        shutil.rmtree(new)  # a save killed while writing
    if os.path.exists(old):
        if os.path.exists(path):
            shutil.rmtree(old)
        else:
            # killed mid-swap: the set-aside directory is the only
            # checkpoint; promote it rather than delete it, so a kill during
            # the write below still leaves one
            os.replace(old, path)
    payload = _state_payload(state)
    flat = {f"{tree}/{name}": t for tree in ("params", "m", "v")
            for name, t in payload.pop(tree).items()}
    flat.update(payload)  # count, step and the seeds: DCP byte entries
    with warnings.catch_warnings():  # "assuming the intent is to save in a single process"
        warnings.simplefilter("ignore", UserWarning)
        dcp.save(flat, checkpoint_id=new, no_dist=True)
    # set the old one aside (a kill between a delete and the install would
    # leave none), install, set the old aux and meta aside too, install
    # them, then delete: until the new meta is in place the set-aside
    # directory with its aux and meta is the newest complete save
    # (``restore_run``)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(new, path)
    for name in (AUX_NAME, META_NAME):
        if os.path.exists(os.path.join(dirname, name)):
            os.replace(os.path.join(dirname, name), os.path.join(dirname, name + PREV_SUFFIX))
    suffix = f".tmp.{os.getpid()}"
    if aux is not None:
        aux_path = os.path.join(dirname, AUX_NAME)
        with open(aux_path + suffix, "wb") as f:
            pickle.dump({**aux, "step": step}, f)
        os.replace(aux_path + suffix, aux_path)
    meta = {"step": step, "backend": DCP_BACKEND, "adam_dtype": state.adam_dtype}
    if extra_meta:
        meta.update(extra_meta)
    meta_path = os.path.join(dirname, META_NAME)
    with open(meta_path + suffix, "w") as f:
        json.dump(meta, f)
    os.replace(meta_path + suffix, meta_path)
    if os.path.exists(old):
        shutil.rmtree(old)
    return path


def restore_run(dirname: str, device="cpu"):
    """(state, aux, meta) of the newest complete save in ``dirname``, for a
    run's ``--resume``. A save writes three things, the state, the aux and
    the meta, each atomically but not jointly (a torch.save save moves the
    old trio aside first), so a kill between two of its renames leaves the
    newest state beside the aux or meta of another save, and the state
    alone would resume the training stream but not the run's history. A
    save is complete when an aux and a meta, current or retained, match its
    state: the same step and the same ``events_fired_at_step`` (two saves
    of one step, at a chunk's end and at that step's events, differ in
    it). Every state on disk is a candidate: the current and the retained
    torch.save checkpoint, the DCP directory and its set-aside ``.old``;
    the newest complete one wins. Where none is complete (a checkpoint
    written before the meta carried the flag), the newest state and the
    current aux and meta, as ``restore_checkpoint`` reads them."""
    path, dcp_path = os.path.join(dirname, CKPT_NAME), os.path.join(dirname, DCP_NAME)
    states = []
    for p, load in ((path, _load), (path + PREV_SUFFIX, _load), (dcp_path, _load_dcp),
                    (dcp_path + ".old", _load_dcp)):
        if os.path.exists(p):
            try:
                states.append(load(p, "cpu"))
            except Exception:  # a set-aside directory a kill left half deleted
                pass
    auxes = [a for a in (restore_checkpoint_aux(dirname, prev) for prev in (False, True))
             if a is not None]
    metas = [m for m in (read_checkpoint_meta(dirname, prev) for prev in (False, True))
             if m is not None and "events_fired_at_step" in m]
    for state in sorted(states, key=lambda st: -st.step):  # stable: current first
        for aux in auxes:
            for meta in metas:
                if (aux.get("step") == meta.get("step") == state.step
                        and aux.get("events_fired_at_step") == meta["events_fired_at_step"]):
                    return state.to(device), aux, meta
    return (restore_checkpoint(dirname, device), restore_checkpoint_aux(dirname),
            read_checkpoint_meta(dirname))


def _dcp_dir(dirname: str) -> Optional[str]:
    """The DCP checkpoint directory, or its set-aside ``.old`` when a kill
    came between the swap's two renames; None if neither exists."""
    path = os.path.join(dirname, DCP_NAME)
    for p in (path, path + ".old"):
        if os.path.exists(p):
            return p
    return None


def _load_dcp(path: str, device) -> TrainState:
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    entries = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    flat = {k: (torch.empty(md.size, dtype=md.properties.dtype)
                if isinstance(md, TensorStorageMetadata) else None)
            for k, md in entries.items()}
    with warnings.catch_warnings():  # "assuming the intent is to load in a single process"
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(flat, checkpoint_id=path, no_dist=True)
    trees: dict = {"params": {}, "m": {}, "v": {}}
    fields = {}
    for key, value in flat.items():
        tree, _, name = key.partition("/")
        if name:
            trees[tree][name] = value
        else:
            fields[key] = value
    return TrainState(**trees, **fields).to(device)
