"""Hand-written CUDA kernels for Hopper and their dispatch.

``linear_vae`` holds K1 and K2, the fused linear-VAE training chunk (K2 with
the sigmoid dataset's dual decoder), and ``mlp_vae`` holds K5, the fused
MLP-VAE training chunk, each with its plain PyTorch version; ``dispatch``
picks one; ``_build`` compiles ``csrc/*.cu`` with nvcc at first use.
Nothing here builds or loads a kernel at import time.
"""
