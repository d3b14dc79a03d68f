"""Hand-written CUDA kernels for Hopper and their dispatch.

``linear_vae`` holds K1, the fused linear-VAE training chunk, with its plain
PyTorch version; ``_build`` compiles ``csrc/*.cu`` with nvcc at first use.
Nothing here builds or loads a kernel at import time.
"""
