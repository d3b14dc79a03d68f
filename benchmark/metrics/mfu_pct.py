"""The whole step's share of the card's dense bf16 peak: the traced
window's row-steps/s times the matmul FLOPs of a row-step (averaged over
the cell's rows), over the peak of the card by its name."""

from benchmark.counts import peaks, row_step_flops


def read(run):
    pk = peaks(run.device_name)
    if pk is None or not run.row_shapes:
        return None
    flops = sum(row_step_flops(run.config, D, L) for D, L in run.row_shapes)
    return 100.0 * run.rate * flops / len(run.row_shapes) / pk[0]
