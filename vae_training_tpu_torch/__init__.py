"""PyTorch + CUDA port of ``vae_training_tpu`` for one NVIDIA Hopper GPU.

The module paths mirror the JAX package so that each port module sits at the
same relative path as its reference counterpart. This slice ports the
linear-VAE training path: the reference CLI, the ``linear_gaussian``
dataset, the pure-linear VAE, the plain PyTorch ("torch path") training
chunk, and the fused multi-step training kernel written in CUDA C++ for
``sm_90a`` (``csrc/linear_vae.cu``).

The package imports ``torch`` and ``numpy`` only; it never imports JAX,
flax, optax or ``vae_training_tpu``.
"""
