"""Kernel backend dispatch: a fused CUDA kernel where one can run, the torch
path otherwise.

Port of ``vae_training_tpu/kernels/dispatch.py:19-40``. ``--kernels``:

  - ``auto``: the linear kernel (``kernels/linear_vae.py``: K1 on
    linear_gaussian, K2 on sigmoid with the dual decoder) where its
    ``supported()`` says yes, else the MLP kernel (``kernels/mlp_vae.py``:
    K5 on sphere and linear_gaussian, its dual branch on sigmoid), else the
    torch path;
  - ``cuda``: one of the kernels, raising with both reasons when neither
    can run;
  - ``torch``: the plain torch path (``train/step.py``).

On the card the torch path runs as one CUDA graph replay a step
(``GraphChunk``), the counterpart of the JAX chunk's one ``lax.scan``
program; ``torch_path_form`` says when it runs op by op instead
(``train_chunk``): on the CPU, under ``-nojit`` (the JAX package's
disabled jit), under ``--debug_nans`` (its chunks run inside
``torch.autograd.detect_anomaly``, which checks every backward on the
host, as ``jax_debug_nans`` re-runs op by op), and for a chunk given
external noise. Every path's losses and state are checked by the engine
under ``--debug_nans``.

Either way one line names the path taken and why, then "with bf16 Adam
moments" under ``--adam_dtype bf16`` (every path takes that mode: the
kernels' K4 branch, the torch path's bf16 update; the JAX package gates no
kernel on it) and, for the torch path, its form after a semicolon. There
is no fallback after the choice: a kernel that fails to build or launch,
and a graph that fails to capture, raise.

``make_grid_chunk`` makes the same choice for the rows of a seed grid or a
one-launch sweep (``train/grid.py``, ``train/mixed_grid.py``): K6a, the
grid mode of the linear kernel, else K6b, the grid mode of the MLP kernel,
each over every row in one launch per chunk (on the CPU its plain version,
one plain chunk per row); else the torch path row by row.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import torch

from ..train import step as torch_step


def _moments(cfg) -> str:
    """The tail of the ``[kernels]`` line: the Adam moment dtype."""
    return " with bf16 Adam moments" if cfg.adam_dtype == "bf16" else ""


def torch_path_form(cfg, noise: bool = False) -> Tuple[bool, str]:
    """(graph?, the words the ``[kernels]`` line gives the form): whether
    the torch path runs as a CUDA graph a step (``GraphChunk``) or op by op
    (``train_chunk``), and why, for a config and a chunk with or without
    an external noise hook."""
    if noise:
        return False, "eager (an external noise hook)"
    if getattr(cfg, "device", "cuda") != "cuda":
        return False, "eager (the CPU has no CUDA graphs)"
    if getattr(cfg, "nojit", False):
        return False, "eager (-nojit)"
    if getattr(cfg, "debug_nans", False):
        return False, ("eager (--debug_nans: each backward under "
                       "torch.autograd.detect_anomaly, which checks on the host)")
    return True, "one CUDA graph replay a step"


def _torch_chunk(model, dataset, cfg):
    """The torch path's ``chunk(state, n_steps, noise=None)`` in the form
    ``torch_path_form`` picks."""
    kwargs = dict(batch_size=cfg.batch_size, lr=float(cfg.learning_rate))
    if torch_path_form(cfg)[0]:
        return torch_step.GraphChunk(model, dataset, **kwargs)
    return _anomaly(partial(torch_step.train_chunk, model, dataset, **kwargs), cfg)


def make_train_chunk(model, dataset, cfg):
    """→ ``train_chunk(state, n_steps)`` for the configured backend."""
    from . import linear_vae, mlp_vae

    if cfg.kernels == "torch":
        why = "--kernels torch"
    elif cfg.nojit:
        if cfg.kernels == "cuda":
            raise ValueError("-nojit selects the plain torch path; drop --kernels cuda")
        why = "-nojit: step-through debugging on the torch path"
    else:
        ok, why_linear = linear_vae.supported(model, dataset, cfg)
        if ok:
            name = "K2" if model.dual_sigmoid_decoder else "K1"
            print(f"[kernels] cuda: fused linear-VAE kernel {name} ({why_linear})"
                  f"{_moments(cfg)}", flush=True)
            return linear_vae.make_train_chunk(model, dataset, cfg)
        ok, why_mlp = mlp_vae.supported(model, dataset, cfg)
        if ok:
            name = "K5 (dual decoder)" if model.dual_sigmoid_decoder else "K5"
            print(f"[kernels] cuda: fused MLP-VAE kernel {name} ({why_mlp}){_moments(cfg)}",
                  flush=True)
            return mlp_vae.make_train_chunk(model, dataset, cfg)
        if cfg.kernels == "cuda":
            raise RuntimeError(f"--kernels cuda requested but no fused kernel can run: "
                               f"linear kernel: {why_linear}; MLP kernel: {why_mlp}")
        # the reason of the kernel this model's shape belongs to
        hidden = (len(model.encoder_features) > 1 or len(model.decoder_features) > 1)
        why = why_mlp if hidden else why_linear
    print(f"[kernels] torch: plain PyTorch path ({why}){_moments(cfg)}; "
          f"{torch_path_form(cfg)[1]}", flush=True)
    return _torch_chunk(model, dataset, cfg)


def _anomaly(chunk, cfg):
    """``chunk`` run inside ``torch.autograd.detect_anomaly`` under
    ``--debug_nans``; ``chunk`` itself otherwise."""
    if not getattr(cfg, "debug_nans", False):  # callers may pass a partial config
        return chunk

    def checked(*args, **kwargs):
        with torch.autograd.detect_anomaly():
            return chunk(*args, **kwargs)

    return checked


def make_grid_chunk(models, datasets, cfg):
    """→ ``chunk(states, n_steps, noises=None)`` over grid rows (one model,
    dataset and config each; ``cfg`` may be one config for all), returning
    (states, (rows, n_steps) losses), for the configured backend."""
    from . import linear_vae, mlp_vae

    cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg] * len(models)
    cfg0, n = cfgs[0], len(models)
    if cfg0.kernels == "torch":
        why = "--kernels torch"
    elif cfg0.nojit:
        if cfg0.kernels == "cuda":
            raise ValueError("-nojit selects the plain torch path; drop --kernels cuda")
        why = "-nojit: step-through debugging on the torch path"
    else:
        on_card, why_dev = linear_vae.cuda_device_ok(cfg0)
        reasons = {}
        for name, module, kernel in (("K6a", linear_vae, "linear-VAE"),
                                     ("K6b", mlp_vae, "MLP-VAE")):
            ok, why_grid = module.grid_supported(models, datasets, cfgs)
            if ok and on_card:
                print(f"[kernels] cuda: {name}, the grid mode of the fused {kernel} kernel, "
                      f"{n} rows in one launch a chunk ({why_grid}){_moments(cfg0)}", flush=True)
                return module.make_grid_chunk(models, datasets, cfg0)
            if ok and cfg0.kernels != "cuda":
                print(f"[kernels] plain: {name}'s plain version on the CPU, {n} rows a chunk, "
                      f"one plain chunk a row ({why_dev}; {why_grid}){_moments(cfg0)}",
                      flush=True)
                return module.make_grid_chunk(models, datasets, cfg0)
            reasons[name] = why_dev if ok else why_grid
        if cfg0.kernels == "cuda":
            raise RuntimeError(f"--kernels cuda requested but no fused kernel can run: "
                               f"linear kernel: {reasons['K6a']}; MLP kernel: {reasons['K6b']}")
        hidden = any(len(m.encoder_features) > 1 or len(m.decoder_features) > 1
                     for m in models)
        why = reasons["K6b"] if hidden else reasons["K6a"]
    print(f"[kernels] torch: plain PyTorch path, row by row for {n} rows ({why})"
          f"{_moments(cfg0)}; {torch_path_form(cfg0)[1]}", flush=True)
    chunks = [_torch_chunk(m, d, c) for m, d, c in zip(models, datasets, cfgs)]

    def chunk(states, n_steps, noises=None):
        out = [c(s, n_steps, noise=None if noises is None else noises[i])
               for i, (c, s) in enumerate(zip(chunks, states))]
        return [s for s, _ in out], torch.stack([losses for _, losses in out])

    return chunk
