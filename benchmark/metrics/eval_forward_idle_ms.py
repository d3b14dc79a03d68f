"""Device-idle ms an eval round while the host runs the eval forward
(``eval.forward``: ``generate``, ``loss_terms`` and the score, every row),
over the window's ``sweep.eval`` records."""

from benchmark.program_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ["eval.forward"], "sweep.eval")
