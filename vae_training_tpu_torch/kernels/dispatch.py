"""Kernel backend dispatch: the fused CUDA kernel where it can run, the
torch path otherwise.

Port of ``vae_training_tpu/kernels/dispatch.py:19-40``. ``--kernels``:

  - ``auto``: K1 (``kernels/linear_vae.py``) where ``supported()`` says yes,
    else the torch path;
  - ``cuda``: K1, raising with the reason when it cannot run;
  - ``torch``: the plain torch path (``train/step.py``).

Either way one line names the path taken and why. There is no fallback
after the choice: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

from functools import partial

from ..train import step as torch_step


def make_train_chunk(model, dataset, cfg):
    """→ ``train_chunk(state, n_steps)`` for the configured backend."""
    from . import linear_vae

    if cfg.kernels == "torch":
        ok, why = False, "--kernels torch"
    elif cfg.nojit:
        if cfg.kernels == "cuda":
            raise ValueError("-nojit selects the plain torch path; drop --kernels cuda")
        ok, why = False, "-nojit: step-through debugging on the torch path"
    else:
        ok, why = linear_vae.supported(model, dataset, cfg)
        if not ok and cfg.kernels == "cuda":
            raise RuntimeError(f"--kernels cuda requested but the fused kernel "
                               f"cannot run: {why}")
    if ok:
        print(f"[kernels] cuda: fused linear-VAE kernel K1 ({why})", flush=True)
        return linear_vae.make_train_chunk(model, dataset, cfg)
    print(f"[kernels] torch: plain PyTorch path ({why})", flush=True)
    return partial(torch_step.train_chunk, model, dataset,
                   batch_size=cfg.batch_size, lr=float(cfg.learning_rate))
