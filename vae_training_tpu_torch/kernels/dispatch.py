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

An epoch dataset (an image corpus, the conv VAE's) always takes the
torch path, one epoch a chunk (``EpochChunk``): on the card one CUDA graph
replay an epoch, else op by op for the same reasons.

Either way one line names the path taken and why, then the modes that
differ from f32: "with bf16-operand dots" where ``--precision bf16``
resolved to bf16 dots (``config.bf16_dots``: on the card; every path takes
that mode: the kernels' bf16-dot instantiations, the torch path's rounded
operands), "with bf16 Adam moments" under ``--adam_dtype bf16`` (the
kernels' K4 branch, the torch path's bf16 update; the JAX package gates no
kernel on either), both joined by "and"; and, for the torch path, its form
after a semicolon. No dot phrase means true fp32 products. There
is no fallback after the choice: a kernel that fails to build or launch,
and a graph that fails to capture, raise.

``make_parallel_chunk`` serves ``--mesh``: the torch path sharded over the
run's ranks (``parallel/``), in the same two forms, the dp step's
all-reduces captured in its graph; the fused kernels are single-device,
so ``--kernels cuda`` with ``--mesh`` raises the JAX engine's message.

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


def _modes(cfg, model) -> str:
    """The tail of the ``[kernels]`` line: the dot mode the model was built
    with and the Adam moment dtype, where they are bf16."""
    modes = (["bf16-operand dots"] if getattr(model, "bf16_dots", False) else []) + (
        ["bf16 Adam moments"] if cfg.adam_dtype == "bf16" else [])
    return " with " + " and ".join(modes) if modes else ""


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
    ``torch_path_form`` picks; for an epoch dataset (an image corpus) its
    ``EpochChunk``, ``chunk(state, epoch, n_batches=None, noise=None)``."""
    kwargs = dict(batch_size=cfg.batch_size, lr=float(cfg.learning_rate))
    graph = torch_path_form(cfg)[0]
    if dataset.is_epochs:
        return _anomaly(torch_step.EpochChunk(model, dataset, graph=graph, **kwargs), cfg)
    if graph:
        return torch_step.GraphChunk(model, dataset, **kwargs)
    return _anomaly(partial(torch_step.train_chunk, model, dataset, **kwargs), cfg)


def make_train_chunk(model, dataset, cfg):
    """→ ``train_chunk(state, n_steps)`` for the configured backend; for an
    epoch dataset, the torch path's ``EpochChunk`` (no fused kernel trains
    an image corpus: ``--kernels cuda`` raises with both kernels'
    reasons)."""
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
                  f"{_modes(cfg, model)}", flush=True)
            return linear_vae.make_train_chunk(model, dataset, cfg)
        ok, why_mlp = mlp_vae.supported(model, dataset, cfg)
        if ok:
            name = "K5 (dual decoder)" if model.dual_sigmoid_decoder else "K5"
            print(f"[kernels] cuda: fused MLP-VAE kernel {name} ({why_mlp})"
                  f"{_modes(cfg, model)}", flush=True)
            return mlp_vae.make_train_chunk(model, dataset, cfg)
        if cfg.kernels == "cuda":
            raise RuntimeError(f"--kernels cuda requested but no fused kernel can run: "
                               f"linear kernel: {why_linear}; MLP kernel: {why_mlp}")
        if dataset.is_epochs:
            why = "an image corpus in epoch mode: the fused kernels train the manifolds"
        else:  # the reason of the kernel this model's shape belongs to
            hidden = (len(model.encoder_features) > 1 or len(model.decoder_features) > 1)
            why = why_mlp if hidden else why_linear
    graph, form = torch_path_form(cfg)
    if dataset.is_epochs:
        form = "one CUDA graph replay an epoch" if graph else f"{form}, one epoch a chunk"
    print(f"[kernels] torch: plain PyTorch path ({why}){_modes(cfg, model)}; {form}",
          flush=True)
    return _torch_chunk(model, dataset, cfg)


def make_parallel_chunk(model, dataset, cfg):
    """→ ``parallel/api.py`` ``ParallelFns`` for ``--mesh``: the torch path
    sharded over the mesh's ranks, data parallel or tensor parallel, in the
    form ``torch_path_form`` picks. The fused kernels are single-device, so
    ``--kernels cuda`` raises the JAX engine's message (``loop.py:265-279``,
    "pallas" read as "cuda"), as does tp in epoch mode. The primary
    process prints the ``[kernels]`` line."""
    from ..parallel.api import make_parallel_step_fns
    from ..parallel.mesh import parse_mesh_spec
    from ..utils.process import is_primary

    if cfg.nojit and cfg.kernels == "cuda":
        raise ValueError("-nojit selects the plain torch path; drop --kernels cuda")
    if cfg.kernels == "cuda":
        raise ValueError(
            "--kernels cuda is single-chip; remove --mesh or use "
            "--kernels auto/torch for mesh training (or shard a seed "
            "grid: --seed_grid ... --mesh dp=N)")
    if dataset.is_epochs and parse_mesh_spec(cfg.mesh).get("tp", 1) > 1:
        raise ValueError(
            "epoch-mode (image) training shards the batch over "
            "dp; use a pure dp spec (e.g. --mesh dp=8)")
    graph, form = torch_path_form(cfg)
    fns = make_parallel_step_fns(model, dataset, cfg, graph=graph, form=form,
                                 debug_wrap=lambda chunk: _anomaly(chunk, cfg))
    if is_primary():
        print(f"[kernels] torch: plain PyTorch path (--mesh {cfg.mesh}: {fns.kind})"
              f"{_modes(cfg, model)}; {fns.form}", flush=True)
    return fns


def _anomaly(chunk, cfg):
    """``chunk`` run inside ``torch.autograd.detect_anomaly`` under
    ``--debug_nans``; ``chunk`` itself otherwise."""
    if not getattr(cfg, "debug_nans", False):  # callers may pass a partial config
        return chunk

    def checked(*args, **kwargs):
        with torch.autograd.detect_anomaly():
            return chunk(*args, **kwargs)

    return checked


def make_grid_chunk(models, datasets, cfg, prefix: str = ""):
    """→ ``chunk(states, n_steps, noises=None)`` over grid rows (one model,
    dataset and config each; ``cfg`` may be one config for all), returning
    (states, (rows, n_steps) losses), for the configured backend. The
    ``[kernels]`` line starts with ``prefix`` (a rank's ``[pK] ``)."""
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
                print(f"{prefix}[kernels] cuda: {name}, the grid mode of the fused {kernel} "
                      f"kernel, {n} rows in one launch a chunk ({why_grid})"
                      f"{_modes(cfg0, models[0])}",
                      flush=True)
                return module.make_grid_chunk(models, datasets, cfg0)
            if ok and cfg0.kernels != "cuda":
                print(f"{prefix}[kernels] plain: {name}'s plain version on the CPU, {n} rows a "
                      f"chunk, one plain chunk a row ({why_dev}; {why_grid})"
                      f"{_modes(cfg0, models[0])}",
                      flush=True)
                return module.make_grid_chunk(models, datasets, cfg0)
            reasons[name] = why_dev if ok else why_grid
        if cfg0.kernels == "cuda":
            raise RuntimeError(f"--kernels cuda requested but no fused kernel can run: "
                               f"linear kernel: {reasons['K6a']}; MLP kernel: {reasons['K6b']}")
        hidden = any(len(m.encoder_features) > 1 or len(m.decoder_features) > 1
                     for m in models)
        why = reasons["K6b"] if hidden else reasons["K6a"]
    print(f"{prefix}[kernels] torch: plain PyTorch path, row by row for {n} rows ({why})"
          f"{_modes(cfg0, models[0])}; {torch_path_form(cfg0)[1]}", flush=True)
    chunks = [_torch_chunk(m, d, c) for m, d, c in zip(models, datasets, cfgs)]

    def chunk(states, n_steps, noises=None):
        out = [c(s, n_steps, noise=None if noises is None else noises[i])
               for i, (c, s) in enumerate(zip(chunks, states))]
        return [s for s, _ in out], torch.stack([losses for _, losses in out])

    return chunk
