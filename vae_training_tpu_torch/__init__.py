"""PyTorch + CUDA port of ``vae_training_tpu`` for one NVIDIA Hopper GPU.

The module paths mirror the JAX package so that each port module sits at the
same relative path as its reference counterpart. Ported so far: the training
paths of the reference's three sweeps (the reference CLI with ``--profile``
and ``--debug_nans``, the ``gaussian``, ``linear_gaussian``, ``sigmoid``
and ``sphere`` datasets, the VAE with ReLU stacks and the dual sigmoid
decoder, the plain PyTorch "torch path" training chunk, one CUDA graph
replay a step on the card), seed grids and the one-launch sweep runner,
artifacts written by a background thread (``runio/background.py``), the
bench and the sampler (``_scripts/bench.py``, ``_scripts/sample.py``), bf16
Adam moments, the library surface (warm starts, ``--track_correlation``
with ``utils/trees.py``, the logistic latent, ``ops/flows.py``,
``ops/images.py``), and every TPU kernel of the
reference as a kernel written by hand in CUDA C++ for ``sm_90a``: K1, K2
and their grid mode K6a
(``csrc/linear_vae.cu``); K5, K5-dual and their grid mode K6b
(``csrc/mlp_vae.cu``); K4, the bf16 moments' branch of both; and the
probes T1 (the sampler's draw, ``csrc/linear_vae.cu``) and T2–T5
(``csrc/probes.cu``), each behind a port of its tool (``tools/``).

The package imports ``torch`` and ``numpy`` only; it never imports JAX,
flax, optax or ``vae_training_tpu``.
"""
