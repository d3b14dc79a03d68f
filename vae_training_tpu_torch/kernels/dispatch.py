"""Kernel backend dispatch: a fused CUDA kernel where one can run, the torch
path otherwise.

Port of ``vae_training_tpu/kernels/dispatch.py:19-40``. ``--kernels``:

  - ``auto``: the linear kernel (``kernels/linear_vae.py``: K1 on
    linear_gaussian, K2 on sigmoid with the dual decoder) where its
    ``supported()`` says yes, else the MLP kernel (``kernels/mlp_vae.py``,
    K5), else the torch path;
  - ``cuda``: one of the kernels, raising with both reasons when neither
    can run;
  - ``torch``: the plain torch path (``train/step.py``).

Either way one line names the path taken and why. There is no fallback
after the choice: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

from functools import partial

from ..train import step as torch_step


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
            print(f"[kernels] cuda: fused linear-VAE kernel {name} ({why_linear})", flush=True)
            return linear_vae.make_train_chunk(model, dataset, cfg)
        ok, why_mlp = mlp_vae.supported(model, dataset, cfg)
        if ok:
            print(f"[kernels] cuda: fused MLP-VAE kernel K5 ({why_mlp})", flush=True)
            return mlp_vae.make_train_chunk(model, dataset, cfg)
        if cfg.kernels == "cuda":
            raise RuntimeError(f"--kernels cuda requested but no fused kernel can run: "
                               f"linear kernel: {why_linear}; MLP kernel: {why_mlp}")
        # the reason of the kernel this model's shape belongs to
        hidden = (len(model.encoder_features) > 1 or len(model.decoder_features) > 1)
        why = why_mlp if hidden else why_linear
    print(f"[kernels] torch: plain PyTorch path ({why})", flush=True)
    return partial(torch_step.train_chunk, model, dataset,
                   batch_size=cfg.batch_size, lr=float(cfg.learning_rate))
