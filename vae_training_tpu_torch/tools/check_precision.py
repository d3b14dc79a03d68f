"""T2 on the card: what the dot modes cost in accuracy and time.

Counterpart of ``tools/check_precision.py:check_dot_modes``. On the TPU a
default f32 dot is single-pass bf16 and ``Precision.HIGHEST`` recovers
fp32. Hopper has no such implicit default, so the port's modes are: fp32
(fmaf chains on the CUDA cores, as the port's kernels sum: the analog of
HIGHEST), tf32 (``wgmma`` on the tensor cores, operands rounded to TF32,
nearest with ties away) and bf16 (``wgmma``, operands rounded to
bfloat16: the tool's "cast"); every mode sums in fp32. At this shape a dot
is 16.8 MFLOP on 0.5 MB that L2 holds, so no rate bounds the kernel
(``csrc/probes.cu`` ``dot_kernel``): latency does, that of the launch, of
each CTA's pull of its operands from L2 and of the steps inside a CTA. So
it cuts the work for latency: 64 × 32 output tiles, K split over the CTAs
of a thread-block cluster (128 CTAs, 32 values of K each), operands staged
in shared memory with every copy in flight at once, and the partial sums
added through distributed shared memory in a fixed order (two calls give
the same bits). One (128×256)·(256×256) dot with N(0,1) operands (numpy
seeds 0 and 1) in each mode, against a float64 host product:

- each mode equals its plain version (rtol 1e-5, atol 1e-4: the products
  are exact, the sums are in another order);
- fp32's max error is under bf16's / 100 (the tool's HIGHEST check);
- TF32's lies between fp32's and bf16's.

Also times each mode, its plain version, and the same dot as one
``torch.matmul`` in fp32, in TF32 (``allow_tf32`` for that call only) and
on bf16 operands (the library's yardsticks).

    python -m vae_training_tpu_torch.tools.check_precision [--device cuda|cpu]

Its second half, ``check_kernel_divergence`` (``tools/check_precision.py:56``),
runs on the card only: it builds the bench's sphere and linear trainers
(``_scripts/bench.py`` ``build``) under ``--precision bf16`` and ``fp32``,
trains each 50 steps and requires the first losses of the two modes to
differ: the flag reaches the fused kernels (K5 and K1). On the CPU both
modes compute fp32 products, so the check is skipped there, and
``--divergence`` (that half alone) exits 2, as the JAX tool does off the
TPU.

    python -m vae_training_tpu_torch.tools.check_precision --divergence
"""

from __future__ import annotations

import contextlib
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels import probes
from ._common import card, device_from, parser, seconds_per_step

M, K, N = 128, 256, 256


def inputs(device) -> tuple:
    x = np.random.RandomState(0).randn(M, K).astype(np.float32)
    w = np.random.RandomState(1).randn(K, N).astype(np.float32)
    return torch.as_tensor(x, device=device), torch.as_tensor(w, device=device)


@contextlib.contextmanager
def tf32_matmul(on: bool):
    """``torch.backends.cuda.matmul.allow_tf32`` set for one call."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def library_call(mode: str, x: torch.Tensor, w: torch.Tensor):
    """One ``torch.matmul`` computing the mode's dot (bf16: on bf16
    operands, which also rounds the output to bf16)."""
    if mode == "bf16":
        xb, wb = x.bfloat16(), w.bfloat16()
        return lambda: torch.matmul(xb, wb)

    def call():
        with tf32_matmul(mode == "tf32"):
            return torch.matmul(x, w)
    return call


def check(device: torch.device) -> dict:
    """Each mode against its plain version and the float64 host product;
    raises on a failed check. Returns the errors."""
    x, w = inputs(device)
    ref = x.double().cpu() @ w.double().cpu()
    err, vs_plain = {}, {}
    with tf32_matmul(False):
        for mode in probes.MODES:
            out = probes.dot_modes(x, w, mode)
            plain = probes.plain_dot_modes(x, w, mode)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out, plain = out.cpu(), plain.cpu()
            if not bool(torch.isfinite(out).all()) or tuple(out.shape) != (M, N):
                raise RuntimeError(f"{mode}: output not finite or not ({M}, {N})")
            np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-5, atol=1e-4,
                                       err_msg=f"dot_modes {mode} vs its plain version")
            vs_plain[mode] = float((out - plain).abs().max())
            err[mode] = float((out.double() - ref).abs().max())
            print(f"{mode:5s} vs host float64 maxdiff: {err[mode]:.3e}; vs its plain version "
                  f"{vs_plain[mode]:.3e}")
    if not err["fp32"] < err["bf16"] / 100:
        raise RuntimeError(f"fp32 error {err['fp32']:.3e} is not under bf16's / 100")
    if not err["fp32"] < err["tf32"] < err["bf16"]:
        raise RuntimeError(f"tf32 error {err['tf32']:.3e} does not lie between fp32's "
                           f"{err['fp32']:.3e} and bf16's {err['bf16']:.3e}")
    print("dot modes: OK (fp32 < bf16/100; fp32 < tf32 < bf16)")
    return {"err": err, "vs_plain": vs_plain}


def times(device: torch.device, min_seconds: float) -> dict:
    """µs a call of each mode's kernel, plain version and library call."""
    x, w = inputs(device)
    out = {}
    with tf32_matmul(False):
        for mode in probes.MODES:
            lib = library_call(mode, x, w)
            for label, fn in (("kernel", lambda m=mode: probes.dot_modes(x, w, m)),
                              ("plain", lambda m=mode: probes.plain_dot_modes(x, w, m)),
                              ("library", lib)):
                def launch(n, fn=fn):
                    for _ in range(n):
                        fn()
                out[(mode, label)] = seconds_per_step(launch, device, min_seconds)[0] * 1e6
            print(f"{mode:5s}: kernel {out[(mode, 'kernel')]:.3f} us, plain "
                  f"{out[(mode, 'plain')]:.3f} us, torch.matmul {out[(mode, 'library')]:.3f} us")
    return out


def check_kernel_divergence(device: torch.device, configs: Sequence[str] = ("sphere", "linear"),
                            steps: int = 50) -> dict:
    """Each bench config trained ``steps`` steps under ``--precision bf16``
    and ``fp32`` on the card; raises unless the first losses differ.
    Returns {config: {precision: losses}}."""
    from .._scripts.bench import build

    if device.type != "cuda":
        raise RuntimeError("check_kernel_divergence runs on the card: on the CPU both "
                           "--precision values compute fp32 products")
    out = {}
    for config in configs:
        losses = {}
        for prec in ("bf16", "fp32"):
            trainer = build("auto", config, prec, device=str(device))
            losses[prec] = trainer.train_chunk(trainer.state, steps)[1].cpu().numpy()
        if not np.isfinite(np.concatenate(list(losses.values()))).all():
            raise RuntimeError(f"{config}: a loss is not finite")
        if losses["bf16"][0] == losses["fp32"][0]:
            raise RuntimeError(f"{config}: --precision fp32 did not change the fused "
                               f"kernel's first step")
        print(f"{config}: kernel step-1 loss bf16={losses['bf16'][0]:.6f} "
              f"fp32={losses['fp32'][0]:.6f} — flag reaches the kernel: OK")
        out[config] = losses
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--divergence", action="store_true",
                   help="run check_kernel_divergence alone (the card only; exits 2 "
                        "elsewhere)")
    args = p.parse_args(argv)
    device = device_from(args.device)
    print(f"card: {card(device)}")
    if args.divergence:
        if device.type != "cuda":
            print("check_kernel_divergence runs on the card", file=sys.stderr)
            sys.exit(2)
        report = {"divergence": check_kernel_divergence(device)}
        print("RESULT: PASS")
        return report
    report = check(device)
    report["us"] = times(device, args.seconds)
    if device.type == "cuda":
        report["divergence"] = check_kernel_divergence(device)
    else:
        print("check_kernel_divergence: skipped on the CPU (both --precision values "
              "compute fp32 products there)")
    print("RESULT: PASS")
    return report


if __name__ == "__main__":
    try:
        main()
    except (RuntimeError, AssertionError) as e:
        print(f"RESULT: FAIL ({e})")
        sys.exit(1)
    sys.exit(0)
