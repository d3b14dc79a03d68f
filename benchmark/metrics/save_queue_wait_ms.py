"""Host ms a plot+save event in ``save.submit`` (the hand-off to the
background writer, which blocks while its queue is full), over the
window's ``sweep.save`` records."""

from benchmark.program_spans import host_ms_per


def read(run):
    return host_ms_per(run, ["save.submit"], "sweep.save")
