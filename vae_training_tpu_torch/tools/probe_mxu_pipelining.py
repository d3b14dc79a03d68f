"""T3 on the card: do independent dots with distinct weights pipeline, or
does every dot pay the full cost of reaching its weights?

Counterpart of ``tools/probe_mxu_pipelining.py`` (``make_kernel``). One,
two or four chains, each of 8 dependent (104×256)·(256×256) fp32 dots a
trip with 8 distinct N(0,1)·0.05 weights a chain (stacked (2048, 256)),
h ~ N(0,1) at the start, each trip renormalised by 1/max(max|h|, 1e-6) a
chain. Inputs come from numpy seeds (the tool's came from jax.random).
Both of the port's forms (``csrc/probes.cu``) are timed:

- ``phase``: the chains' dot d share one phase of the phase kernel (one
  cooperative launch, a grid-wide phase a dot); each dot reads its own
  256 KB of weights from L2, one thread an output;
- ``stream``: one cluster of 16 CTAs a chain (T4's cut), each warp
  streaming its K slice of the next dot's weights from L2 into a ring in
  shared memory while the current dot runs; the trip's max|y| met through
  distributed shared memory.

    python -m vae_training_tpu_torch.tools.probe_mxu_pipelining [--device cuda|cpu]

Prints ns a dot for 1, 2 and 4 chains and, per form, the VERDICT line: the
independence speed-up (> 1.3 ⇒ interleaving rows pays).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels import probes
from ._common import card, device_from, parser, seconds_per_step


def inputs(n_chains: int, device) -> tuple:
    """Chain r: h ~ N(0,1) from seed r, weights ~ N(0,1)·0.05 from seed 100 + r."""
    xs = [np.random.RandomState(r).randn(probes.ROWS, probes.W) for r in range(n_chains)]
    ws = [np.random.RandomState(100 + r).randn(probes.T3_DEPTH * probes.W, probes.W) * 0.05
          for r in range(n_chains)]
    as_t = lambda a: torch.as_tensor(np.stack(a).astype(np.float32), device=device)  # noqa: E731
    return as_t(xs), as_t(ws)


def run(device: torch.device, form: str, n_chains: int, min_seconds: float):
    """(ns a dot, trips a call) of ``form`` at ``n_chains``."""
    xs, ws = inputs(n_chains, device)
    out: List[torch.Tensor] = []

    def launch(n):
        out[:] = [probes.chain_chunk(xs, ws, n_steps=n, depth=probes.T3_DEPTH,
                                     weights_per_depth=True, epilogue="renorm", form=form)]

    per_trip, n = seconds_per_step(launch, device, min_seconds)
    return per_trip / (probes.T3_DEPTH * n_chains) * 1e9, n


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_from(args.device)
    print(f"card: {card(device)}")
    report = {}
    for form in probes.T3_FORMS:
        ns = {}
        for n_chains in (1, 2, 4):
            ns[n_chains], n = run(device, form, n_chains, args.seconds)
            dots = n * probes.T3_DEPTH * n_chains
            print(f"  {form:6s} chains={n_chains}: {n} trips a call ({dots} dots) -> "
                  f"{ns[n_chains]:7.1f} ns/dot")
        x2, x4 = ns[1] / ns[2], ns[1] / ns[4]
        print(f"VERDICT ({form}): independence speedup: x2={x2:.2f}  x4={x4:.2f} "
              f"(>1.3 => interleaving the sphere grid kernel pays)")
        report[form] = {"ns_per_dot": ns, "x2": x2, "x4": x4}
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
