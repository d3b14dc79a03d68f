"""Host clock of the training thread's stall at each plot+save event (every
group's ``plot_all`` and ``save_all``: host copies, figures where
matplotlib is present, and the hand-off to the background writer),
averaged over the window's events. Nothing to read without a save."""


def read(run):
    rounds = run.spans.rounds("save")
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
