"""K6b, the MLP kernel's grid mode (``mlp_vae_chunk_kernel`` over a table
of rows): the least time a launch-step could take, from the benchmark's
own operation and byte counts, over its device time a launch-step in the
trace. Nothing to read where K6b did not launch."""

from benchmark.counts import kernel_roofline


def read(run):
    return kernel_roofline(run, "K6b", "mlp_vae_chunk_kernel")
