"""Device-idle ms a chunk while the host finishes it: ``chunk.unpack``
(``unpack_rows``) and ``chunk.losses`` (the losses' copy to the host, the
states' hand-back, ``record_losses``), over the window's ``sweep.chunk``
records."""

from benchmark.program_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ["chunk.unpack", "chunk.losses"], "sweep.chunk")
