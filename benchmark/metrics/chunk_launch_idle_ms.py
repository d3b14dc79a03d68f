"""Device-idle ms a chunk while the host prepares and makes the launch
(``chunk.launch``: ``run_grid_chunk``'s checks, the row table and its copy
to the card, the launch call), over the window's ``sweep.chunk`` records."""

from benchmark.program_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ["chunk.launch"], "sweep.chunk")
