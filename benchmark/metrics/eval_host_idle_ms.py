"""Device-idle ms an eval round while the host takes the results
(``eval.to_host``: ``eval_to_host``, the recorder and the stat line, every
row), over the window's ``sweep.eval`` records."""

from benchmark.program_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ["eval.to_host"], "sweep.eval")
