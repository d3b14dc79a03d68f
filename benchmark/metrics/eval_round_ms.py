"""Host clock of one eval round of every row (each group's
``compute_and_write_stats``, from the first start to the last end; a round
ends in its host copies), averaged over the window's rounds. Nothing to
read in a window without evals."""


def read(run):
    rounds = run.spans.rounds("eval")
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
