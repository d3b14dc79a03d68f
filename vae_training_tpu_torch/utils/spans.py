"""Named spans of the port's host work, on the host clock and, under a
profiler, on the device trace's clock too.

    from ..utils.spans import span

    with span("sweep.eval", tag=step):
        ...

Always, each span adds its seconds to a count and a sum by name
(``totals()``): the sweep's ``[sweep] wall accounting`` lines print from
them. That costs two clock reads and a dict update a span.

Only while a torch profiler runs (``torch.profiler.profile``, or the
autograd profiler: ``torch.autograd.profiler._is_profiler_enabled``, a
plain bool, is the switch; there is no flag or variable of its own), a span
also

  - opens a ``record_function`` range of its name, so that the program's
    spans land in any Chrome trace the profiler exports, on the same clock
    as the device's kernels and copies;
  - appends a ``Record`` (``records()``): its name, ``perf_counter_ns``
    start and end, the id of the span open around it on the same thread
    (its parent), the thread and the tag. ``clear()`` empties the records
    and the totals.

Outside a profiler no record is kept and ``record_function`` is never
called (it costs several µs a call even then).

The names are dotted by layer: ``sweep.*`` the sweep's loop
(``train/mixed_grid.py``), ``chunk.*`` a grid chunk's host work (the grid
closures of ``kernels/linear_vae.py`` and ``kernels/mlp_vae.py``),
``eval.*`` an eval (``train/step.py``, ``train/grid.py``), ``save.*`` a
save event (``train/grid.py``). No name starts with ``bench.``: that
prefix is the benchmark's own.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _profiler


class Record(NamedTuple):
    """One span taken while a profiler ran; times are ``perf_counter_ns``."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    tag: object


_lock = threading.Lock()
_totals: Dict[str, List[float]] = {}  # name → [count, seconds]
_records: List[Record] = []
_ids = itertools.count()
_open = threading.local()  # .stack: ids of this thread's open recorded spans


class span:
    """A context manager timing its body under ``name`` (module
    docstring)."""

    __slots__ = ("name", "tag", "_t0", "_range", "_id", "_parent")

    def __init__(self, name: str, tag=None):
        self.name, self.tag = name, tag

    def __enter__(self) -> "span":
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            self._id, self._parent = next(_ids), (stack[-1] if stack else None)
            stack.append(self._id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        with _lock:
            tot = _totals.get(self.name)
            if tot is None:
                tot = _totals[self.name] = [0, 0.0]
            tot[0] += 1
            tot[1] += (t1 - self._t0) * 1e-9
            if self._range is not None:
                _records.append(Record(self._id, self.name, self._t0, t1, self._parent,
                                       threading.get_ident(), self.tag))
        if self._range is not None:
            _open.stack.pop()
            self._range.__exit__(*exc)


def totals() -> Dict[str, Tuple[int, float]]:
    """(count, seconds) of every span name since the last ``clear()``."""
    with _lock:
        return {name: (int(c), s) for name, (c, s) in _totals.items()}


def seconds(name: str, since: Optional[Dict[str, Tuple[int, float]]] = None) -> float:
    """Seconds spent in ``name``, all told or since a ``totals()`` reading."""
    now = totals().get(name, (0, 0.0))[1]
    return now - (since or {}).get(name, (0, 0.0))[1]


def records() -> List[Record]:
    """The spans taken under a profiler since the last ``clear()``, by
    start."""
    with _lock:
        return sorted(_records, key=lambda r: (r.start_ns, -r.end_ns))


def clear() -> None:
    with _lock:
        _totals.clear()
        _records.clear()
