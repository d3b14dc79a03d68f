"""Run one child process under deadlines: the sweep runner's supervised rows.

Port of ``vae_training_tpu/_scripts/_supervise.py:30-137`` (``Outcome``,
``run_supervised``). ``vae-sweep-torch --isolate`` runs every row in a
process of its own under this supervisor, because on the card one row's
fault must not cost the rest of the sweep: a sticky CUDA error (an illegal
address, a launch failure in one of the MLP kernel's cluster barriers)
poisons the process's CUDA context, so every later row of an in-process
sweep fails too, and a kernel that hangs stalls the sweep for good. In a
process of its own, the row ends at its deadline, its CUDA context goes
with the process, and a retry resumes from the row's checkpoint
(``sweep.run_isolated``).

Two deadlines, as in the JAX module. Until the child shows a sign of life
``init_timeout`` applies, afterwards only ``total_timeout``. A sign of life
is any stdout line, or a stderr line holding ``init_marker``: the port's
CLI (``_scripts/run.py``) prints ``device: cuda (<card>)`` to stderr right
after it validates the config and before it builds the dataset, so a row
whose kernels are still being compiled at first use (``nvcc``,
``kernels/_build.py``: seconds a library, minutes on a loaded host) is a
live child and only ever meets the total deadline, never the init one.

stderr is always forwarded as it arrives; stdout is forwarded
(``"forward"``) or collected and returned (``"capture"``).

Termination, at either deadline and on every exit path of the parent: the
child gets SIGTERM, then 30 s, then SIGKILL. The JAX module then sleeps
``VAE_TPU_KILL_COOLDOWN`` (300 s) before a retry, to wait out the TPU's
device-grant wedge after a SIGKILL; there is no such wedge here, since a
killed process's CUDA context is freed when the process is reaped, so
neither the cooldown nor its variable is ported. The child is started
with the parent's death as its SIGTERM (``PR_SET_PDEATHSIG`` on Linux), so
it is not orphaned even when the parent itself is killed and its
``finally`` never runs.

Standard library only: the supervising parent never imports ``torch``, so
it can never hold a CUDA context of its own.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

TERM_GRACE = 30.0  # seconds between SIGTERM and SIGKILL


@dataclass
class Outcome:
    """What happened to one supervised attempt."""

    returncode: int | None  # the child's own exit code; None if a deadline ended it
    hung: bool              # a deadline fired and the child was terminated
    init_hang: bool         # the deadline that fired was the init deadline
    stdout: str             # captured stdout ("" in forward mode)


def _die_with_parent():
    """A ``preexec_fn`` that asks the kernel to SIGTERM the child when its
    parent dies (Linux's ``PR_SET_PDEATHSIG``), or None elsewhere. The libc
    call is looked up here, in the parent: the child between fork and exec
    only calls it."""
    if not sys.platform.startswith("linux"):
        return None
    import ctypes

    prctl = ctypes.CDLL(None, use_errno=True).prctl
    return lambda: prctl(1, signal.SIGTERM)  # 1: PR_SET_PDEATHSIG


def run_supervised(
    argv: list[str],
    *,
    init_timeout: float,
    total_timeout: float,
    env: dict | None = None,
    init_marker: str = "device:",
    stdout_mode: str = "forward",  # "forward" | "capture"
    label: str = "supervisor",
    note: str = "",
) -> Outcome:
    """Run ``argv`` once under supervision; never raises on the child's
    trouble (a crash is its return code, a hang ``hung``)."""
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, text=True, preexec_fn=_die_with_parent(),
    )
    init_seen = threading.Event()
    captured: list[str] = []

    def read_stderr(stream=proc.stderr):
        for line in stream:
            if init_marker in line:
                init_seen.set()
            sys.stderr.write(line)
            sys.stderr.flush()

    def read_stdout(stream=proc.stdout):
        for line in stream:
            init_seen.set()  # any stdout: the child is past its start
            if stdout_mode == "capture":
                captured.append(line)
            else:
                sys.stdout.write(line)
                sys.stdout.flush()

    hung = init_hang = False
    readers = [threading.Thread(target=read_stderr, daemon=True),
               threading.Thread(target=read_stdout, daemon=True)]
    try:
        for r in readers:
            r.start()
        start = time.monotonic()
        while proc.poll() is None:
            elapsed = time.monotonic() - start
            if not init_seen.is_set() and elapsed > init_timeout:
                print(f"[{label}] no output after {init_timeout:.0f}s "
                      f"(init hang){note}; terminating", file=sys.stderr, flush=True)
                hung = init_hang = True
                break
            if elapsed > total_timeout:
                print(f"[{label}] run exceeded {total_timeout:.0f}s{note}; terminating",
                      file=sys.stderr, flush=True)
                hung = True
                break
            time.sleep(1.0)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=TERM_GRACE)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for r in readers:
            if r.is_alive():
                r.join(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    return Outcome(returncode=None if hung else proc.returncode,
                   hung=hung, init_hang=init_hang, stdout="".join(captured))
