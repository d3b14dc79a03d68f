"""Host ms a plot+save event in ``save.copy`` (each row's ``host_copy()``
and the recorder's ``to_state()`` on the training thread), over the
window's ``sweep.save`` records."""

from benchmark.program_spans import host_ms_per


def read(run):
    return host_ms_per(run, ["save.copy"], "sweep.save")
