"""Background writer for a run's artifacts: losses.npz, model.pkl and the
checkpoint trio.

Port of ``vae_training_tpu/runio/background.py``. A save at the plot
cadence writes, for every row of a run, a checkpoint, a model.pkl and a
losses.npz; none of it is on the training path, so the writes overlap the
next chunks on the card. One process-wide worker thread does them all:

  - FIFO order keeps each directory's write sequence (losses.npz →
    model.pkl → checkpoint), so the checkpoint's step-ordering guard and
    its ``.prev`` retention (``runio/checkpoint.py``) see monotone steps,
    as when the writes were synchronous;
  - a job closes over HOST copies only, taken on the training thread at
    submit time (``host_state``, ``StatsRecorder.to_state()``): the kernels
    and the torch path update the parameters and moments in place, so a
    job that held device tensors would write a later step's state. The
    thread touches no CUDA tensor;
  - the queue is bounded: at the bound ``submit`` blocks, so producers that
    outrun the disk do not pile up copies of the state.

The first failure of a job is stored and re-raised (chained) on the next
``submit`` or at ``drain``: a failed write fails the run. ``drain_quietly``
is for crash paths: it flushes what is queued and logs a stored failure
rather than masking the error in flight. Figures stay on the training
thread (the card's machine has no matplotlib, and ``SigmoidDataset``'s
figure draws a true sample on the device).
"""

from __future__ import annotations

import queue
import sys
import threading
import traceback
from typing import Callable, Optional


class ArtifactWriter:
    """One FIFO worker thread for host IO jobs."""

    def __init__(self):
        # each queued job holds a host copy of a run's state and history
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._err: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="artifact-writer")
            self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            try:
                job()
            except BaseException as e:  # stored; raised on submit or drain
                with self._lock:
                    if self._err is None:
                        self._err = e
            finally:
                self._q.task_done()

    def submit(self, job: Callable[[], None]) -> None:
        """Queue a host IO job; raises if an earlier job failed."""
        self._raise_if_failed()
        self._ensure_thread()
        self._q.put(job)

    def drain(self) -> None:
        """Wait for every queued job; raise a stored failure."""
        self._q.join()
        self._raise_if_failed()

    def drain_quietly(self) -> None:
        """Drain without raising, for crash paths where the error in flight
        must not be masked. A stored failure is logged before it is
        dropped: it may be the only trace that a checkpoint never reached
        the disk."""
        try:
            self.drain()
        except Exception:
            print("[artifact-writer] background write failed during crash-path drain "
                  "(not masking the in-flight error):", file=sys.stderr, flush=True)
            traceback.print_exc(file=sys.stderr)

    def _raise_if_failed(self) -> None:
        with self._lock:
            err, self._err = self._err, None
        if err is not None:
            raise RuntimeError("background artifact write failed (first failure chained)") \
                from err


_writer: Optional[ArtifactWriter] = None


def get_artifact_writer() -> ArtifactWriter:
    """The process-wide writer: one thread for every trainer and grid group."""
    global _writer
    if _writer is None:
        _writer = ArtifactWriter()
    return _writer
