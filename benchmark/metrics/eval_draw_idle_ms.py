"""Device-idle ms an eval round while the host draws the eval batches
(``eval.draw``: ``dataset.sample`` and ``sample_z``, every row), over the
window's ``sweep.eval`` records."""

from benchmark.program_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ["eval.draw"], "sweep.eval")
