"""The work a step needs, counted from shapes, and the card's peaks.

``mlp_step_flops`` is the matmul count the repository's benches use (a
Dense forward (B, k)·(k, n) costs 2·B·k·n; the backward's two products as
much again each, so training is 3× the forward; elementwise work is not
counted), copied here so that the work counted is the same whatever
implements it. ``launch_step_bytes`` is the least traffic to the card's
memory a launch-step needs: a chunk reads every row's parameters and both
Adam moments once and writes them once, and writes one loss a row a step.

``PEAKS`` are NVIDIA's data-sheet rates without sparsity at the part's full
power limit: dense bf16 tensor-core FLOP/s and HBM bytes/s, by a fragment
of the name ``torch.cuda.get_device_name`` gives.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

PEAKS = (("H100 NVL", 835e12, 3.9e12), ("H100 PCIe", 756e12, 2.0e12),
         ("H100 80GB HBM3", 989.4e12, 3.35e12), ("H100 SXM", 989.4e12, 3.35e12))


def peaks(device_name: str) -> Optional[Tuple[float, float]]:
    """(bf16 FLOP/s, bytes/s) of the card, or None when it is not listed."""
    for frag, flops, bw in PEAKS:
        if frag in device_name:
            return flops, bw
    return None


def mlp_step_flops(batch: int, data_dim: int, latent_dim: int,
                   enc_features: Sequence[int], dec_features: Sequence[int],
                   dual: bool = False) -> int:
    """Matmul FLOPs of one training step of the VAE (``enc_features`` and
    ``dec_features`` include the output widths)."""
    def net(in_dim, feats):
        fl, d = 0, in_dim
        for f in feats:
            fl += 2 * batch * d * f
            d = f
        return fl

    fwd = net(data_dim, enc_features) + net(latent_dim, dec_features) * (2 if dual else 1)
    return 3 * fwd


def n_params(D: int, L: int, hidden_enc: Sequence[int], hidden_dec: Sequence[int],
             tdv: bool = True) -> int:
    """Parameters of one row: both stacks' kernels and biases, the
    posterior log-variance (L) and the decoder's variance scale."""
    total = 0
    for widths in ((D, *hidden_enc, L), (L, *hidden_dec, D)):
        total += sum(a * b + b for a, b in zip(widths, widths[1:]))
    return total + L + (1 if tdv else 0)


def launch_step_bytes(rows: Sequence[Tuple[int, int]], hidden_enc, hidden_dec,
                      steps_per_launch: int, tdv: bool = True) -> float:
    """Least bytes a launch-step moves: parameters, m and v (float32) read
    and written once a launch, and a float32 loss a row a step. ``rows``
    holds each row's (D, L)."""
    state = sum(3 * 4 * n_params(D, L, hidden_enc, hidden_dec, tdv) for D, L in rows)
    return 2 * state / steps_per_launch + 4 * len(rows)


def roofline_pct(flops: float, nbytes: float, device_seconds: float,
                 device_name: str) -> Optional[float]:
    """Share, in %, of the least time the work could take on the card
    (operations over the bf16 peak or bytes over the memory rate, whichever
    is longer) in the time it took; None without a listed peak or a time."""
    pk = peaks(device_name)
    if pk is None or not device_seconds or device_seconds <= 0:
        return None
    least = max(flops / pk[0], nbytes / pk[1])
    return 100.0 * least / device_seconds


def hidden(spec: str) -> tuple:
    return tuple(int(s) for s in spec.split("|")) if spec else ()


def row_step_flops(config: dict, D: int, L: int) -> int:
    """``mlp_step_flops`` of one row of a configuration: data dim ``D``
    (with padding), latent dim ``L``."""
    enc, dec = hidden(config["encoder_layer_sizes"]), hidden(config["layer_sizes"])
    return mlp_step_flops(config["batch_size"], D, L, (*enc, L), (*dec, D))


def kernel_roofline(run, kernel: str, fragment: str) -> Optional[float]:
    """A per-layer reader's body: the roofline share of ``kernel`` (the
    program's launch counter) over the traced window, its device time the
    kernels named with ``fragment``; None where it did not run."""
    if not run.counts.get(kernel) or not run.launch_steps:
        return None
    seconds = run.trace.kernel_seconds(fragment)
    if seconds <= 0:
        return None
    cfg = run.config
    enc, dec = hidden(cfg["encoder_layer_sizes"]), hidden(cfg["layer_sizes"])
    flops = sum(row_step_flops(cfg, D, L) for D, L in run.row_shapes)
    nbytes = launch_step_bytes(run.row_shapes, enc, dec, run.launch_steps / run.launches,
                               cfg["tunable_decoder_var"])
    return roofline_pct(flops, nbytes, seconds / run.launch_steps, run.device_name)
