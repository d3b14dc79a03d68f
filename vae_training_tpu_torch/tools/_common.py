"""What the probes share: the device flag, the card's name, the dot modes,
and timing.

A time is one window of at least ``min_seconds``, after a warm-up window
of the same size: on a CUDA device with CUDA events around the window and a
sync after every call, so the queue never runs ahead of the window (as
``chip_smoke.py`` times the kernels); on the CPU with the host clock, and
then it is no device number.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..kernels.probes import W

# The dot modes T3, T4 and T5 run, in turn, as ``bf16_dots``: first the TPU
# tools' own (``jnp.dot`` at precision=None: bf16 operands, f32 sums), then
# fp32 products
DOT_MODES = {"bf16": True, "fp32": False}


def two_term_weights(rs: np.random.RandomState, n: int) -> np.ndarray:
    """``n`` (W, W) weights stacked, (n·W, W), float64: each column holds two
    nonzeros, 0.7·N(0, 1), in rows of distinct 16-row blocks (the bf16 dots'
    k16 steps). A dot by such a weight sums two products, so in bf16 dots
    (exact products) and in fp32 alike its f32 sum is one rounding in any
    order: a chain of them is bitwise the same in every implementation of
    the mode, where dense weights make two summation orders part within a
    few dots (a rounding to bf16 flipped by a last-bit difference changes
    the next dot's every output). The values are not bf16 values, so the
    two modes differ."""
    w = np.zeros((n * W, W))
    cols = np.arange(W)
    for b in range(n):
        r1 = rs.permutation(W)
        r2 = (r1 + 16 * rs.randint(1, W // 16, W)) % W
        w[b * W + r1, cols] = 0.7 * rs.randn(W)
        w[b * W + r2, cols] = 0.7 * rs.randn(W)
    return w


def parser(description: str, timed: bool = True) -> argparse.ArgumentParser:
    """``--device``, and for a tool that times, ``--seconds``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the default) runs the CUDA kernels; cpu their plain "
                        "PyTorch versions")
    if timed:
        p.add_argument("--seconds", type=float, default=1.0,
                       help="the least length of each timed window (default 1 s)")
    return p


def device_from(name: str) -> torch.device:
    """``--device`` as a torch device; cuda without a GPU is an error."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to run the plain versions on the CPU)")
    return torch.device(name)


def card(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi prints them; for the
    CPU a line that says its times are the host's."""
    if device.type != "cuda":
        return "cpu (host-clock times of the plain versions, not device numbers)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
        return out[torch.cuda.current_device()] if out else torch.cuda.get_device_name()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name()} (power limit not read)"


def _window(launch: Callable[[int], object], n: int, min_seconds: float,
            device: torch.device) -> Tuple[float, int]:
    """Seconds of ``calls`` calls of ``launch(n)`` lasting ≥ min_seconds."""
    calls = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        while True:
            launch(n)
            calls += 1
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
            if seconds >= min_seconds:
                return seconds, calls
    t0 = time.perf_counter()
    while True:
        launch(n)
        calls += 1
        seconds = time.perf_counter() - t0
        if seconds >= min_seconds:
            return seconds, calls


def seconds_per_step(launch: Callable[[int], object], device: torch.device,
                     min_seconds: float = 1.0) -> Tuple[float, int]:
    """Time ``launch(n)``, which runs n steps. The steps a call are sized
    so a call lasts about a quarter of the window (from calls of 1, 2, 4,
    ... steps); then one warm-up window and one timed window. Returns
    (seconds a step, steps a call)."""
    n, target = 1, min_seconds / 4
    while True:
        seconds, _ = _window(launch, n, 0.0, device)
        if seconds >= target / 8 or n >= 1 << 24:
            break
        n *= 2 if seconds <= 0 else max(2, min(64, int(target / 8 / seconds) + 1))
    n = max(1, int(round(n * target / max(seconds, 1e-9))))
    _window(launch, n, min_seconds, device)  # warm-up
    seconds, calls = _window(launch, n, min_seconds, device)
    return seconds / (calls * n), n


def event_us(fn: Callable[[], object], calls: int = 5, repeats: int = 3) -> float:
    """µs a call of ``fn`` in device time: ``calls`` calls queued back to
    back between two CUDA events, the least of ``repeats`` runs after a
    warm-up call. For launches long beside their host cost (a cooperative
    launch, which a CUDA graph may not capture, included)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        best = min(best, 1e3 * start.elapsed_time(end) / calls)
    return best


def split_in_turns(launches: Mapping[str, Callable[[str], object]], variants: Sequence[str],
                   scale: float = 1.0) -> Dict[str, Dict[str, float]]:
    """A kernel's time split by launch variants that leave parts out: each
    variant in order and then in reverse, and at each variant every launch
    of ``launches`` in turn (one form at two chain counts, say, or two
    builds), in device time (``event_us``). Returns {launch: {variant: the
    least of the two times × ``scale``}}, ``scale`` turning µs a launch into
    the unit wanted (µs or ns a step or dot)."""
    out: Dict[str, Dict[str, float]] = {key: {} for key in launches}
    for variant in list(variants) + list(variants)[::-1]:
        for key, launch in launches.items():
            t = scale * event_us(lambda: launch(variant))
            out[key][variant] = min(out[key].get(variant, float("inf")), t)
    return out
