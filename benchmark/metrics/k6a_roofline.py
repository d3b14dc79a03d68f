"""K6a, the linear kernel's grid mode (``linear_vae_chunk_kernel``, one CTA
a row): as ``k6b_roofline``. Nothing to read where K6a did not
launch."""

from benchmark.counts import kernel_roofline


def read(run):
    return kernel_roofline(run, "K6a", "linear_vae_chunk_kernel")
