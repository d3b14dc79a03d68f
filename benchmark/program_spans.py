"""The program's own spans (``vae_training_tpu_torch/utils/spans.py``: its
records, kept while a profiler runs) joined to a ``--trace 1`` window, for
the per-layer readers that split the device's idle time by what the host
was doing.

Clocks: the records are on ``time.perf_counter_ns``, the trace on the
profiler's clock. The harness times each window chunk twice, as the
``bench.chunk`` range in the trace and as its own ``perf_counter`` span
(``run.spans.spans["chunk"]``), one right after the other, so each chunk
gives one reading of the offset between the clocks (the two starts'
difference). The offset is the readings' median; their largest distance
from it is logged on standard error as the alignment error.

Attribution: each piece of the window's device-idle time (the complement
of ``run.trace.busy_intervals()`` inside the ``bench.window`` range) goes
to the innermost program span open on the training thread (the thread of
the ``sweep.chunk`` records) at that moment; idle time under no program
span is unattributed.

Where the program keeps no records (a program without the span module,
or no ``sweep.chunk`` in the window), every reader reads nothing.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional, Sequence, Tuple

_MISSING = object()


def program_records() -> Optional[list]:
    """The program's span records, or None where it keeps none."""
    try:
        from vae_training_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.records()


def _innermost(spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Nested spans of one thread (sorted by start, longest first) as
    disjoint pieces, each named by the innermost span that covers it."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []  # (end, name) of the open spans
    cursor = 0.0

    def emit(s, e, name):
        if e > s:
            out.append((s, e, name))

    for s, e, name in spans:
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            emit(cursor, end, top)
            cursor = end
        if stack:
            emit(cursor, s, stack[-1][1])
            e = min(e, stack[-1][0])
        stack.append((e, name))
        cursor = s
    while stack:
        end, top = stack.pop()
        emit(cursor, end, top)
        cursor = end
    return out


class Join:
    """The window's program spans on the trace's clock: ``count`` and
    ``host_us`` by name, ``idle_us`` (device-idle µs by innermost span),
    ``idle_total_us`` and ``unattributed_us``."""

    def __init__(self, trace, chunk_spans: Sequence[tuple], records: Sequence):
        bench = trace.host["bench.chunk"]
        if len(bench) != len(chunk_spans):
            raise ValueError(f"the trace holds {len(bench)} bench.chunk ranges, the harness "
                             f"{len(chunk_spans)} chunk spans")
        offsets = [b[0] - c[0] * 1e6 for b, c in zip(bench, chunk_spans)]
        self.n_offsets = len(offsets)
        self.offset_us = statistics.median(offsets) if offsets else 0.0
        self.alignment_error_us = max((abs(o - self.offset_us) for o in offsets), default=0.0)

        def on_trace(r):
            return r.start_ns / 1e3 + self.offset_us, r.end_ns / 1e3 + self.offset_us

        window = [(r, *on_trace(r)) for r in records
                  if trace.t0 <= on_trace(r)[0] <= trace.t1]
        chunks = [r for r, _, _ in window if r.name == "sweep.chunk"]
        self.thread = chunks[0].thread if chunks else None
        mine = [(s, e, r.name) for r, s, e in window if r.thread == self.thread]
        self.count: Dict[str, int] = {}
        self.host_us: Dict[str, float] = {}
        for s, e, name in mine:
            self.count[name] = self.count.get(name, 0) + 1
            self.host_us[name] = self.host_us.get(name, 0.0) + (e - s)

        gaps, prev = [], trace.t0
        for s, e in trace.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if trace.t1 > prev:
            gaps.append((prev, trace.t1))
        self.idle_total_us = sum(e - s for s, e in gaps)
        self.idle_us: Dict[str, float] = {}
        pieces = _innermost(sorted(mine, key=lambda x: (x[0], -x[1])))
        j = 0
        for gs, ge in gaps:
            while j < len(pieces) and pieces[j][1] <= gs:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0] < ge:
                s, e, name = pieces[k]
                over = min(e, ge) - max(s, gs)
                if over > 0:
                    self.idle_us[name] = self.idle_us.get(name, 0.0) + over
                k += 1
        self.unattributed_us = max(self.idle_total_us - sum(self.idle_us.values()), 0.0)
        # of it, before the first span and after the last: the window's ends
        first, last = (pieces[0][0], pieces[-1][1]) if pieces else (trace.t1, trace.t1)
        self.unattributed_ends_us = sum(max(min(e, first) - s, 0.0) + max(e - max(s, last), 0.0)
                                        for s, e in gaps)

    def idle_ms_per(self, names: Sequence[str], per: str) -> Optional[float]:
        """Device-idle ms under ``names`` per window record of ``per``."""
        n = self.count.get(per, 0)
        return sum(self.idle_us.get(k, 0.0) for k in names) / 1e3 / n if n else None

    def host_ms_per(self, names: Sequence[str], per: str) -> Optional[float]:
        """Host ms in ``names`` per window record of ``per``."""
        n = self.count.get(per, 0)
        return sum(self.host_us.get(k, 0.0) for k in names) / 1e3 / n if n else None

    def unattributed_pct(self) -> float:
        if self.idle_total_us <= 0:
            return 0.0
        return 100.0 * self.unattributed_us / self.idle_total_us


def joined(run) -> Optional[Join]:
    """The run's join, made once (None where the program keeps no records
    of the window)."""
    got = getattr(run, "_program_spans", _MISSING)
    if got is not _MISSING:
        return got
    records = program_records()
    got = None
    if records and any(r.name == "sweep.chunk" for r in records):
        got = Join(run.trace, run.spans.spans.get("chunk", []), records)
        if got.thread is None:
            got = None
        else:
            print(f"[bench] program spans: {sum(got.count.values())} in the window; clock "
                  f"offset {got.offset_us:.3f} us, alignment error {got.alignment_error_us:.3f} "
                  f"us (largest distance from the median over {got.n_offsets} chunks); idle "
                  f"{got.idle_total_us / 1e6:.6f} s, unattributed "
                  f"{got.unattributed_us / 1e6:.6f} s ({got.unattributed_ends_us / 1e6:.6f} s "
                  f"of it at the window's ends); by innermost span (s): "
                  + ", ".join(f"{k} {v / 1e6:.6f}" for k, v in sorted(got.idle_us.items())),
                  file=sys.stderr, flush=True)
    run._program_spans = got
    return got


def idle_ms_per(run, names: Sequence[str], per: str) -> Optional[float]:
    j = joined(run)
    return None if j is None else j.idle_ms_per(names, per)


def host_ms_per(run, names: Sequence[str], per: str) -> Optional[float]:
    j = joined(run)
    return None if j is None else j.host_ms_per(names, per)
