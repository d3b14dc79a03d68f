"""Device-idle ms a chunk while the host packs the rows (the program's
``chunk.pack`` span: the ``GridRow`` list and ``pack_rows``), over the
window's ``sweep.chunk`` records (``benchmark/program_spans.py``)."""

from benchmark.program_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ["chunk.pack"], "sweep.chunk")
