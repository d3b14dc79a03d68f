"""The traced window: ``torch.profiler`` (CPU and CUDA activity) around it,
its Chrome trace read back, reduced to what the per-layer readers and the
result line need.

The device is busy where a kernel, a copy or a memset runs; ``busy_s`` is
the length of the union of those intervals inside the window, whose bounds
are the ``bench.window`` range. Idle gaps are the rest of the window, each
named by the harness's host span (``bench.chunk``, ``bench.eval``,
``bench.save``) that holds its midpoint, else ``other``.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("bench.eval", "bench.save", "bench.chunk")  # the first that holds a gap names it


class Trace:
    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("name") == "bench.window"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no bench.window range")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                             for e in events if e.get("cat") in DEVICE_CATS)
        self.kernels = [(n, s, e) for s, e, n in self.device]
        self.host = {name: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                                  for e in events if e.get("name") == name
                                  and e.get("cat") == "user_annotation")
                     for name in HOST_SPANS}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_seconds(self, fragment: str) -> float:
        """Device seconds, inside the window, of the kernels whose name holds
        ``fragment``."""
        return sum(min(e, self.t1) - max(s, self.t0) for n, s, e in self.kernels
                   if fragment in n and min(e, self.t1) > max(s, self.t0)) / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for s, e, n in self.device:
            if min(e, self.t1) > max(s, self.t0):
                by[n] = by.get(n, 0.0) + (min(e, self.t1) - max(s, self.t0)) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds of the window summed by what the host was doing."""
        gaps, prev = [], self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        starts = {name: [a for a, _ in spans] for name, spans in self.host.items()}
        by: Dict[str, float] = {}
        for s, e in gaps:
            mid, label = (s + e) / 2, "other"
            for name in HOST_SPANS:
                i = bisect.bisect_right(starts[name], mid) - 1
                if i >= 0 and mid <= self.host[name][i][1]:
                    label = name
                    break
            by[label] = by.get(label, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def profiled(fn: Callable[[], float]) -> Tuple[float, Trace]:
    """``fn()`` (the window) under the profiler; its result and the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function("bench.window"):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, Trace(events)
