"""The port's counterparts of the JAX package's ``tools/`` probes, one
module each under the tool's own name, run as

    python -m vae_training_tpu_torch.tools.<name> [--device cuda|cpu]

- ``probe_mlp_interleave`` (T4): do independent chains of dependent dots
  hide in each other's stalls? The phase and cluster kernels.
- ``probe_mxu_pipelining`` (T3): do chains with distinct weights a dot
  pipeline, or does each dot pay for its weights?
- ``probe_adam_overlap`` (T5): does Adam interleaved with the dots cost
  less than Adam in a tail?
- ``check_precision`` (T2): one dot in fp32, TF32 and bf16 modes against a
  float64 host product.
- ``check_kernel_rng`` (T1): the statistical battery of the kernels'
  Philox sampler.

Each has ``main(argv)``; ``--device cuda`` (the default) without a GPU is
an error. The kernels are ``csrc/probes.cu`` (``kernels/probes.py``) and,
for T1, the training kernels' sampler (``kernels/linear_vae.py``).
"""
