"""T5 on the card: does Adam interleaved with the dependent dots cost less
than Adam in a tail after them?

Counterpart of ``tools/probe_adam_overlap.py`` (``_kernel``). A step is 25
dependent (104×256)·(256×256) dots over 5 weight buffers (5 dots each,
min(·, 8) after each) and f32 Adam on the 5 buffers, the gradient of
buffer d being the column mean of h ·1e-6(d + 1), lr 1e-9. Each dot runs
in the tool's own mode, bf16 operands (h and the buffer's current f32
values rounded) with f32 sums (its ``jnp.dot`` at precision=None on the
TPU), and then in fp32, in turn (``_common.DOT_MODES``). Both of the
port's forms (``csrc/probes.cu``) are timed in both modes:

- ``phase``: a step is 26 grid-wide phases of the phase kernel either way:
  in the tail, one Adam phase over the 5 buffers after the 25th dot (K5's
  structure; every gradient from the final h); interleaved, buffer d's
  Adam as extra items of the phase of dot 5(d + 1), from h after dot
  5d + 4, the last buffer in a phase of its own;
- ``stream``: one cluster of 16 CTAs, each warp streaming its K slice of
  the next dot's weights into shared memory; Adam split over the 16 CTAs
  after the column sums of h meet in distributed shared memory, once after
  the 25th dot (tail) or after dot 5d + 4 for buffer d (interleaved),
  each followed by a cluster barrier that orders the new weights before
  their next copies.

    python -m vae_training_tpu_torch.tools.probe_adam_overlap [--device cuda|cpu]

Times tail, interleaved, interleaved, tail (in turns) for each form and dot
mode and prints its VERDICT line: interleaved/tail (< 0.93 ⇒ overlap).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import probes
from ._common import DOT_MODES, card, device_from, parser, seconds_per_step

ORDER = ("tail", "interleaved", "interleaved", "tail")
DELTA_RTOL = 1e-3  # delta_mismatch's bound for a kernel held to its plain version


def inputs(device) -> tuple:
    """The tool's x (0.01), weights eye·(1 + 1e-4d) and zero moments."""
    x = torch.full((probes.ROWS, probes.W), 0.01, device=device)
    ws = torch.stack([torch.eye(probes.W) * (1.0 + 1e-4 * d) for d in range(probes.N_BUF)])
    zeros = torch.zeros(probes.N_BUF, probes.W, probes.W)
    return x, ws.to(device), zeros.to(device), zeros.clone().to(device)


def check_inputs(device) -> tuple:
    """Inputs on which Adam's arithmetic shows, for holding the kernel to
    its plain version (numpy-made from seed 0). x lies in [0.01, 0.05)
    element by element, so the columns' means differ. Weight d is diagonal,
    1 + 0.01d + 0.005u, so h, and with it the gradient, grows ~10% a buffer
    along the chain: the tail's gradients differ from the interleaved ones.
    m and v start near the first gradients' scale (|g| ~ 3e-8), so Adam's
    history, its square root and ε all weigh. Off the diagonal w starts at
    0, so w − w0 there is the update rounded once."""
    rs = np.random.RandomState(0)
    x = 0.01 + 0.04 * rs.rand(probes.ROWS, probes.W)
    ws = np.stack([np.diag(1.0 + 0.01 * d + 0.005 * rs.rand(probes.W))
                   for d in range(probes.N_BUF)])
    ms = 3e-8 * rs.randn(probes.N_BUF, probes.W, probes.W)
    vs = 1e-18 * (0.5 + rs.rand(probes.N_BUF, probes.W, probes.W))
    return tuple(torch.as_tensor(a.astype(np.float32)).to(device) for a in (x, ws, ms, vs))


def delta_mismatch(got: torch.Tensor, ref: torch.Tensor, start: torch.Tensor) -> float:
    """What a run changed held to the reference's change at its own size:
    max over the elements of |Δgot − Δref| / (|Δref| + max|Δref|), Δ = · −
    ``start``. At most DELTA_RTOL is rtol 1e-3 at atol 1e-3·max|Δref|; inf
    where the reference did not move."""
    dg, dr = (got - start).double(), (ref - start).double()
    top = float(dr.abs().max())
    if top == 0.0:
        return math.inf
    return float(((dg - dr).abs() / (dr.abs() + top)).max())


def run(device: torch.device, form: str, interleave: bool, min_seconds: float,
        bf16_dots: bool = False):
    """(µs a step, steps a call, checksum) of one variant of ``form`` in the
    dot mode."""
    x, ws, ms, vs = inputs(device)
    out: List[torch.Tensor] = []
    done = [0]

    def launch(n):
        out[:] = [probes.adam_overlap_chunk(x, ws, ms, vs, n_steps=n, interleave=interleave,
                                            t0=done[0], form=form, bf16_dots=bf16_dots)]
        done[0] += n

    per_step, n = seconds_per_step(launch, device, min_seconds)
    return per_step * 1e6, n, float(out[0][0, 0]) + float(ws[0, 0, 1])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_from(args.device)
    print(f"card: {card(device)}")
    print(f"{probes.N_BUF * probes.DOTS_PER_BUF} serial {probes.ROWS}x{probes.W}x{probes.W} "
          f"dots + Adam over {probes.N_BUF}x{probes.W}x{probes.W} params/step")
    report = {mode: {} for mode in DOT_MODES}
    for form in probes.T5_FORMS:
        for mode, bf16_dots in DOT_MODES.items():
            res: Dict[str, List[float]] = {}
            for label in ORDER:
                us, n, checksum = run(device, form, label == "interleaved", args.seconds,
                                      bf16_dots)
                res.setdefault(label, []).append(us)
                print(f"  {form:6s} {mode} {label:12s}: {us:.3f} us/step, {n} steps a call "
                      f"(checksum {checksum:.6g})")
            tail, inter = min(res["tail"]), min(res["interleaved"])
            ratio = inter / tail
            overlap = ratio < 0.93
            print(f"VERDICT ({form}, {mode} dots): interleaved/tail = {ratio:.3f}x "
                  f"({'OVERLAP — restructure the kernel' if overlap else 'no overlap — keep the tail loop'})")
            report[mode][form] = {"us_per_step": res, "ratio": ratio, "overlap": overlap}
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
