"""The share of the traced window in which no kernel, copy or memset runs
on the card."""


def read(run):
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
