"""T1 on the card: the statistical battery of the kernels' sampler.

Counterpart of ``tools/check_kernel_rng.py``. The TPU tool drew from the
TPU's hardware PRNG in a Pallas kernel; the port's kernels draw from
Philox4x32-10 and Box–Muller (``csrc/philox.cuh``), which
``kernels/linear_vae.py:sampler_normals`` runs on its own (the kernel
``philox_draw_kernel`` in ``csrc/linear_vae.cu``, normals only). Its
words equal ``ops/rng.py``'s bitwise and its normals those of the words
entry, ``sampler_check`` (``chip_smoke.py`` phases 3 and 30); this battery
checks the normals' statistics, at the tool's sizes and bounds:

1. 4,194,304 normals (two seeds): |mean| and |std − 1| < 5e-3; χ² over 100
   exact-quantile N(0,1) bins (edges from ``torch.special.ndtri`` in
   float64) below 99 + 5·√198; the Box–Muller cos/sin partners' |ρ| < 0.01.
2. Lag-1 to lag-4 autocorrelation across 128 consecutive steps (128×128
   normals a step) of one stream, |ρ| < 0.01.
3. The four streams ``STREAM_MANIFOLD``, ``STREAM_Z1``, ``STREAM_Z2`` and
   ``STREAM_OBS`` (``ops/rng.py``) at the same step, rows and seed,
   1,048,576 normals each: each stream's mean, std, skew and excess
   kurtosis at the tool's bounds (5e-3, 5e-3, 0.02, 0.04), and their 4×4
   correlation, max |off-diagonal| < 0.01. These streams stand in for the
   TPU kernel's packed lane windows, which the port does not have.
4. 16 row streams keyed as K6a's and K6b's rows are,
   ``rng.derive_seed(seed, rng.SEED_TRAIN_DATA)`` for 16 seeds: 16
   distinct keys and all-pairs |ρ| < 0.02 over 262,144 normals each.

    python -m vae_training_tpu_torch.tools.check_kernel_rng [--device cuda|cpu]

``--device cpu`` runs the same battery on ``ops/rng.py`` (the sampler's
plain version). Prints RESULT: PASS or FAIL (exit 1).
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Dict, Optional, Sequence

import torch

from ..kernels import linear_vae as k1
from ..ops import rng
from ._common import card, device_from, parser

# draw(seed, step, rows, stream, n_draws) → (rows, 4·n_draws) float32 normals
Draw = Callable[[int, int, int, int, int], torch.Tensor]

N_DRAWS = 32  # Philox calls a row: 128 normals a row
SIZES = {"global_rows": 16384, "lag_rows": 128, "lag_steps": 128, "stream_rows": 8192,
         "row_rows": 2048}
ROW_SEEDS = tuple(range(1000, 1016))
CHI2_LIMIT = 99 + 5 * math.sqrt(2 * 99)


def card_draw(device) -> Draw:
    """The kernel's sampler on the card: the normals-only draw."""
    def draw(seed, step, rows, stream, n_draws):
        return k1.sampler_normals(rows, n_draws, step, stream, seed, device).reshape(rows, -1)
    return draw


def plain_draw(seed, step, rows, stream, n_draws) -> torch.Tensor:
    """The sampler's plain version, ``ops/rng.py``."""
    return rng.box_muller(rng.words(seed, step, rows, stream, n_draws)).reshape(rows, -1)


def _stats4(x: torch.Tensor):
    m, s = x.mean(), x.std(unbiased=False)
    return (float(m), float(s), float(((x - m) ** 3).mean() / s ** 3),
            float(((x - m) ** 4).mean() / s ** 4 - 3.0))


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.corrcoef(torch.stack([a, b]))[0, 1])


def _flag(ok: bool) -> str:
    return "PASS" if ok else "FAIL"


def global_battery(draw: Draw, rows: int) -> bool:
    x4 = torch.cat([draw(seed, 0, rows, rng.STREAM_MANIFOLD, N_DRAWS).double().cpu()
                    for seed in (12345, 54321)])
    x = x4.reshape(-1)
    mean, std, skew, kurt = _stats4(x)
    print(f"n={x.numel()}  mean={mean:+.5f}  std={std:.5f}  skew={skew:+.5f}  "
          f"ex.kurt={kurt:+.5f}")
    edges = torch.special.ndtri(torch.linspace(0.0, 1.0, 101, dtype=torch.float64))
    counts = torch.bucketize(x, edges[1:-1]).bincount(minlength=100).double()
    expected = x.numel() / 100.0
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    pairs = x4.reshape(-1, 4)
    partner = max(abs(_corr(pairs[:, 0], pairs[:, 1])), abs(_corr(pairs[:, 2], pairs[:, 3])))
    ok = (chi2 < CHI2_LIMIT and abs(mean) < 5e-3 and abs(std - 1) < 5e-3 and partner < 0.01)
    print(f"chi2(99 dof)={chi2:.1f} (limit {CHI2_LIMIT:.1f}); cos/sin partner |corr| "
          f"max={partner:.5f} -> {_flag(ok)}")
    return ok


def cross_step_battery(draw: Draw, rows: int, steps: int, seed: int = 1357) -> bool:
    s = torch.stack([draw(seed, t, rows, rng.STREAM_Z1, N_DRAWS).double().cpu().reshape(-1)
                     for t in range(steps)])
    ok = True
    for lag in (1, 2, 3, 4):
        c = _corr(s[:-lag].reshape(-1), s[lag:].reshape(-1))
        ok = ok and abs(c) < 0.01
        print(f"  cross-step lag-{lag} autocorrelation={c:+.5f} (n={s[lag:].numel()}) "
              f"-> {_flag(abs(c) < 0.01)}")
    return ok


def stream_battery(draw: Draw, rows: int, seed: int = 2468, step: int = 7) -> bool:
    names = {"manifold": rng.STREAM_MANIFOLD, "z1": rng.STREAM_Z1, "z2": rng.STREAM_Z2,
             "obs": rng.STREAM_OBS}
    flat: Dict[str, torch.Tensor] = {}
    ok = True
    for name, sid in names.items():
        w = draw(seed, step, rows, sid, N_DRAWS).double().cpu().reshape(-1)
        flat[name] = w
        m, s, sk, ku = _stats4(w)
        w_ok = abs(m) < 5e-3 and abs(s - 1) < 5e-3 and abs(sk) < 0.02 and abs(ku) < 0.04
        ok = ok and w_ok
        print(f"  stream {name:8s}: mean={m:+.5f} std={s:.5f} skew={sk:+.5f} "
              f"ex.kurt={ku:+.5f} (n={w.numel()}) -> {_flag(w_ok)}")
    corr = torch.corrcoef(torch.stack(list(flat.values())))
    off = float(corr[~torch.eye(4, dtype=torch.bool)].abs().max())
    print("  cross-stream correlation matrix (order: manifold, z1, z2, obs):")
    for row in corr.tolist():
        print("   ", "  ".join(f"{v:+.5f}" for v in row))
    print(f"  max |off-diagonal| = {off:.5f} -> {_flag(off < 0.01)}")
    return ok and off < 0.01


def cross_row_battery(draw: Draw, rows: int, seeds: Sequence[int] = ROW_SEEDS) -> bool:
    keys = [rng.derive_seed(s, rng.SEED_TRAIN_DATA) for s in seeds]
    uniq = len(set(keys))
    print(f"  {len(keys)} row keys derive_seed(seed, SEED_TRAIN_DATA), {uniq} distinct: "
          f"{[f'{k:016x}' for k in keys[:3]]}...")
    streams = torch.stack([draw(k, 0, rows, rng.STREAM_MANIFOLD, N_DRAWS).double().cpu()
                           .reshape(-1) for k in keys])
    corr = torch.corrcoef(streams)
    off = corr[~torch.eye(len(keys), dtype=torch.bool)].abs()
    ok = uniq == len(keys) and float(off.max()) < 0.02
    print(f"  all-pairs stream correlation: max |corr| = {float(off.max()):.5f}, mean |corr| = "
          f"{float(off.mean()):.5f} ({off.numel() // 2} pairs, n={streams.shape[1]} each) "
          f"-> {_flag(ok)}")
    return ok


def battery(draw: Draw) -> bool:
    """The four checks on ``draw``; prints each and returns whether all pass."""
    ok = global_battery(draw, SIZES["global_rows"])
    print("cross-step battery:")
    ok = cross_step_battery(draw, SIZES["lag_rows"], SIZES["lag_steps"]) and ok
    print("cross-stream battery:")
    ok = stream_battery(draw, SIZES["stream_rows"]) and ok
    print("cross-row (grid keys) battery:")
    ok = cross_row_battery(draw, SIZES["row_rows"]) and ok
    print("RESULT:", _flag(ok))
    return ok


def main(argv: Optional[Sequence[str]] = None) -> bool:
    args = parser(__doc__.splitlines()[0], timed=False).parse_args(argv)
    device = device_from(args.device)
    print(f"card: {card(device)}")
    return battery(card_draw(device) if device.type == "cuda" else plain_draw)


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
