"""T4 on the card: are the MLP kernel's dependent dots latency-bound enough
that two or four independent chains cost little more than one?

Counterpart of ``tools/probe_mlp_interleave.py`` (``_chain_kernel``). Each
chain runs 24 dependent (104×256)·(256×256) dots a step, chain c with the
weight eye·(1 + 1e-4c) and min(·, 8) after each dot, from h = 0.01(c + 1).
On the TPU the chains were interleaved op by op in one kernel body; here
they share each dot's phase: that is how K6b runs its rows. Each dot runs
in the tool's own mode, bf16 operands with f32 sums (its ``jnp.dot`` at
precision=None on the TPU), and then in fp32, in turn
(``_common.DOT_MODES``). Both of the port's forms are timed in both modes,
for 1, 2, 1, 2 and 4 chains (the tool's order):

- ``phase``: the MLP kernel's former design, one cooperative launch, one
  grid-wide phase a dot (one thread an output, a 256-term FMA chain from
  L2, ``grid.sync()``; bf16 dots: 16 × 32 outputs over 8 warps that split
  K, each warp's operands from L2 in one round trip);
- ``cluster``: one cluster of 16 CTAs a chain, 8 row groups × 2 column
  slices, W's slice in registers and the row group's rows of h in shared
  memory, each CTA's new rows pushed to its row group's other CTA, no grid
  or cluster barrier a dot.

    python -m vae_training_tpu_torch.tools.probe_mlp_interleave [--device cuda|cpu]

Prints µs a step for each run and, per form and dot mode, the VERDICT
line: the 2- and 4-chain cost ratios against one chain and the aggregate
win.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import probes
from ._common import (DOT_MODES, card, device_from, parser, seconds_per_step,
                      two_term_weights)

ORDER = (1, 2, 1, 2, 4)


def inputs(n_chains: int, device) -> tuple:
    """The tool's xs (0.01(c + 1) everywhere) and ws (eye·(1 + 1e-4c))."""
    xs = torch.stack([torch.full((probes.ROWS, probes.W), 0.01 * (c + 1))
                      for c in range(n_chains)]).to(device)
    ws = torch.stack([torch.eye(probes.W) * (1.0 + 1e-4 * c) for c in range(n_chains)])
    return xs, ws.to(device)


def check_inputs(n_chains: int, device) -> tuple:
    """Random inputs for holding both forms to the plain version (numpy-made
    from seed 0): xs 3·N(0, 1), ws 0.05·N(0, 1), one (W, W) weight a
    chain. Unlike the tool's constant h and diagonal W, they fail a
    transposed or permuted weight slice, a misplaced exchange and a dropped
    off-diagonal term. The first dots take a few outputs a chain past the
    clamp; each dot scales h by ~0.8, so 8 dots stay in float32's range."""
    rs = np.random.RandomState(0)
    xs = 3.0 * rs.randn(n_chains, probes.ROWS, probes.W)
    ws = 0.05 * rs.randn(n_chains, probes.W, probes.W)
    return tuple(torch.as_tensor(a.astype(np.float32)).to(device) for a in (xs, ws))


def two_term_inputs(n_chains: int, device) -> tuple:
    """Inputs whose chain is bitwise the same in every implementation of a
    dot mode (numpy-made from seed 1): xs 3·N(0, 1), ws of two nonzeros a
    column (``_common.two_term_weights``), one a chain. They hold a form to
    its plain version over the tool's whole steps, where dense weights
    (``check_inputs``) hold only to the summation order's drift."""
    rs = np.random.RandomState(1)
    xs = 3.0 * rs.randn(n_chains, probes.ROWS, probes.W)
    ws = np.stack([two_term_weights(rs, 1) for _ in range(n_chains)])
    return tuple(torch.as_tensor(a.astype(np.float32)).to(device) for a in (xs, ws))


def run(device: torch.device, form: str, n_chains: int, min_seconds: float,
        bf16_dots: bool = False):
    """(µs a step, steps a call, checksum) of one form at ``n_chains`` in the
    dot mode."""
    xs, ws = inputs(n_chains, device)
    out: List[torch.Tensor] = []

    def launch(n):
        out[:] = [probes.chain_chunk(xs, ws, n_steps=n, depth=probes.T4_DEPTH,
                                     weights_per_depth=False, epilogue="clamp", form=form,
                                     bf16_dots=bf16_dots)]

    per_step, n = seconds_per_step(launch, device, min_seconds)
    return per_step * 1e6, n, float(out[0][:, 0, 0].sum())


def verdict(results: Dict[int, List[float]]) -> str:
    one, two, four = (min(results[c]) for c in (1, 2, 4))
    return (f"2-chain cost ratio {two / one:.2f}x for 2x work (aggregate win "
            f"{2 * one / two:.2f}x); 4-chain {four / one:.2f}x for 4x work "
            f"(win {4 * one / four:.2f}x)")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_from(args.device)
    print(f"card: {card(device)}")
    print(f"chain: {probes.T4_DEPTH} serially-dependent {probes.ROWS}x{probes.W}x{probes.W} "
          f"dots/step, {' then '.join(DOT_MODES)} dots, windows >= {args.seconds} s")
    report = {mode: {} for mode in DOT_MODES}
    for form in probes.T4_FORMS:
        for mode, bf16_dots in DOT_MODES.items():
            results: Dict[int, List[float]] = {}
            for n_chains in ORDER:
                us, n, checksum = run(device, form, n_chains, args.seconds, bf16_dots)
                results.setdefault(n_chains, []).append(us)
                print(f"  {form:7s} {mode} chains={n_chains}: {us:.3f} us/step, {n} steps a "
                      f"call (checksum {checksum:.4f})")
            line = verdict(results)
            print(f"VERDICT ({form}, {mode} dots): {line}")
            report[mode][form] = {"us_per_step": results, "verdict": line}
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
