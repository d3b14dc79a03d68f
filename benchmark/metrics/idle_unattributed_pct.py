"""The share of the window's device-idle time under no program span on
the training thread: how much of the idle time the program's spans leave
unexplained (``benchmark/program_spans.py``)."""

from benchmark.program_spans import joined


def read(run):
    j = joined(run)
    return None if j is None else j.unattributed_pct()
