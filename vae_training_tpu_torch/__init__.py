"""PyTorch + CUDA port of ``vae_training_tpu`` for one NVIDIA Hopper GPU.

The module paths mirror the JAX package so that each port module sits at the
same relative path as its reference counterpart. Ported so far: the training
paths of the reference's three sweeps: the reference CLI, the
``linear_gaussian``, ``sigmoid`` and ``sphere`` datasets, the VAE with ReLU
stacks and the dual sigmoid decoder, the plain PyTorch ("torch path")
training chunk, and the fused multi-step training kernels written in CUDA
C++ for ``sm_90a``: K1 and K2 (``csrc/linear_vae.cu``) and K5
(``csrc/mlp_vae.cu``).

The package imports ``torch`` and ``numpy`` only; it never imports JAX,
flax, optax or ``vae_training_tpu``.
"""
