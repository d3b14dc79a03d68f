"""T3 on the card: do independent dots with distinct weights pipeline, or
does every dot pay the full cost of reaching its weights?

Counterpart of ``tools/probe_mxu_pipelining.py`` (``make_kernel``). One,
two or four chains, each of 8 dependent (104×256)·(256×256) dots a trip
with 8 distinct N(0,1)·0.05 weights a chain (stacked (2048, 256)), h ~
N(0,1) at the start, each trip renormalised by 1/max(max|h|, 1e-6) a
chain. Inputs come from numpy seeds (the tool's came from jax.random).
Each dot runs in the tool's own mode, bf16 operands with f32 sums (its
``jnp.dot`` at precision=None on the TPU), and then in fp32, in turn
(``_common.DOT_MODES``). Both of the port's forms (``csrc/probes.cu``) are
timed:

- ``phase``: the chains' dot d share one phase of the phase kernel (one
  cooperative launch, a grid-wide phase a dot); each dot reads its own
  256 KB of weights from L2, one thread an output (bf16 dots: 16 × 32
  outputs over 8 warps that split K);
- ``stream``: one cluster of 16 CTAs a chain (T4's cut), each warp
  streaming its K slice of the next dot's weights from L2 into a ring in
  shared memory while the current dot runs; the trip's max|y| met through
  distributed shared memory.

    python -m vae_training_tpu_torch.tools.probe_mxu_pipelining [--device cuda|cpu]

Prints ns a dot for 1, 2 and 4 chains and, per form and dot mode, the
VERDICT line: the independence speed-up (> 1.3 ⇒ interleaving rows pays).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels import probes
from ._common import (DOT_MODES, card, device_from, parser, seconds_per_step,
                      two_term_weights)


def inputs(n_chains: int, device) -> tuple:
    """Chain r: h ~ N(0,1) from seed r, weights ~ N(0,1)·0.05 from seed 100 + r."""
    xs = [np.random.RandomState(r).randn(probes.ROWS, probes.W) for r in range(n_chains)]
    ws = [np.random.RandomState(100 + r).randn(probes.T3_DEPTH * probes.W, probes.W) * 0.05
          for r in range(n_chains)]
    as_t = lambda a: torch.as_tensor(np.stack(a).astype(np.float32), device=device)  # noqa: E731
    return as_t(xs), as_t(ws)


def two_term_inputs(n_chains: int, device) -> tuple:
    """Inputs whose chain is bitwise the same in every implementation of a
    dot mode (numpy-made from seed 1): h ~ N(0, 1), 8 weights a chain of two
    nonzeros a column each (``_common.two_term_weights``)."""
    rs = np.random.RandomState(1)
    xs = rs.randn(n_chains, probes.ROWS, probes.W)
    ws = np.stack([two_term_weights(rs, probes.T3_DEPTH) for _ in range(n_chains)])
    return tuple(torch.as_tensor(a.astype(np.float32)).to(device) for a in (xs, ws))


def dense_trip_inputs(n_chains: int, device) -> tuple:
    """A trip that is one dense dot: 7 identities, then ``inputs``' first
    weight, from ``inputs``' h. An identity dot of bf16 operands rounds h to
    bf16, exactly and in any summation order, and rounding again changes
    nothing, so a stream launch (whole trips) is held one dense dot deep, as
    the phase form is on the first weight alone. (With the dense weight
    first, the next identity would round its f32 outputs to bf16, and a
    last-bit difference between two right summation orders would flip such
    a rounding.)"""
    xs, ws = inputs(n_chains, device)
    eye = torch.eye(probes.W, device=device).expand(n_chains, probes.W, probes.W)
    return xs, torch.cat([eye] * (probes.T3_DEPTH - 1) + [ws[:, :probes.W]], dim=1).contiguous()


def run(device: torch.device, form: str, n_chains: int, min_seconds: float,
        bf16_dots: bool = False):
    """(ns a dot, trips a call) of ``form`` at ``n_chains`` in the dot mode."""
    xs, ws = inputs(n_chains, device)
    out: List[torch.Tensor] = []

    def launch(n):
        out[:] = [probes.chain_chunk(xs, ws, n_steps=n, depth=probes.T3_DEPTH,
                                     weights_per_depth=True, epilogue="renorm", form=form,
                                     bf16_dots=bf16_dots)]

    per_trip, n = seconds_per_step(launch, device, min_seconds)
    return per_trip / (probes.T3_DEPTH * n_chains) * 1e9, n


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_from(args.device)
    print(f"card: {card(device)}")
    report = {mode: {} for mode in DOT_MODES}
    for form in probes.T3_FORMS:
        for mode, bf16_dots in DOT_MODES.items():
            ns = {}
            for n_chains in (1, 2, 4):
                ns[n_chains], n = run(device, form, n_chains, args.seconds, bf16_dots)
                dots = n * probes.T3_DEPTH * n_chains
                print(f"  {form:6s} {mode} chains={n_chains}: {n} trips a call ({dots} dots) "
                      f"-> {ns[n_chains]:7.1f} ns/dot")
            x2, x4 = ns[1] / ns[2], ns[1] / ns[4]
            print(f"VERDICT ({form}, {mode} dots): independence speedup: x2={x2:.2f}  "
                  f"x4={x4:.2f} (>1.3 => interleaving the sphere grid kernel pays)")
            report[mode][form] = {"ns_per_dot": ns, "x2": x2, "x4": x4}
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
