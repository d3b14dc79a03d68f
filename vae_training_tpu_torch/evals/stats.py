"""Stat aggregation, console writer, and losses.npz persistence.

A verbatim copy of ``vae_training_tpu/evals/stats.py`` (numpy only), so the
console line and the ``losses.npz`` layout stay identical between the two
packages. That module's docstring lists the reference quirks it keeps:
the interleaved "VAE Loss" trace, the (2, 0) "EigenValues" pair, the empty
"Average Log Likelihood" for dict-scoring datasets, and the final-only
"Correlation Ratio".
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

import numpy as np


class StatsRecorder:
    def __init__(self):
        self.stats: Dict[str, List] = defaultdict(list)
        self.vae_losses: List = []  # interleaved: eval scalars + train chunks
        self.var_enc: List = []  # posterior log-var vector per eval
        self.var_dec: List = []  # decoder log-var per eval
        self.average_log_likelihoods: List = []
        self.correlation_ratios: List = []
        # {param path: per-eval ratio history} — the reference's
        # per-parameter landscape diagnostic granularity (vae.py:149-177);
        # written as "Correlation Ratio/<path>" channels on the final save
        # when --track_correlation populated it.
        self.correlation_ratios_per_param: Dict[str, List] = {}

    def append_train_losses(self, losses: np.ndarray) -> None:
        self.vae_losses.append(np.asarray(losses).reshape(-1))

    def append_eval(self, loss, logvar_e, epsilon) -> None:
        self.vae_losses.append(np.asarray(loss).reshape(-1))
        self.var_enc.append(np.asarray(logvar_e))
        self.var_dec.append(np.asarray(epsilon))

    def write_stats(self, batchnum: int, stats: Dict, is_epochs: bool = False,
                    console_only: Dict | None = None) -> str:
        """Append to history and return the console line.

        Format matches the reference's model.py:195-205:
        ``Batch | N | stat | val | stat | val ...`` (3 decimal places).

        ``console_only`` entries (e.g. the wall-clock steps/sec rate) appear
        on the console line but are NOT recorded: they are non-deterministic,
        absent from the reference's losses.npz contract, and recording them
        would break resumed-run artifact equality.
        """
        label = "Epoch" if is_epochs else "Batch"
        message = f"{label} | {batchnum}"
        for stat, val in stats.items():
            self.stats[stat].append(val)
            try:
                fval = float(val)
            except Exception:
                continue
            message += f" | {stat} | {fval:.3f}"
        for stat, val in (console_only or {}).items():
            message += f" | {stat} | {float(val):.3f}"
        return message

    def to_state(self) -> Dict:
        """Host snapshot of the full stat history for checkpointing (shallow
        list copies — entries are never mutated in place, only appended)."""
        return {
            "stats": {k: list(v) for k, v in self.stats.items()},
            "vae_losses": list(self.vae_losses),
            "var_enc": list(self.var_enc),
            "var_dec": list(self.var_dec),
            "average_log_likelihoods": list(self.average_log_likelihoods),
            "correlation_ratios": list(self.correlation_ratios),
            "correlation_ratios_per_param": {
                k: list(v) for k, v in self.correlation_ratios_per_param.items()
            },
        }

    @classmethod
    def from_state(cls, state: Dict) -> "StatsRecorder":
        rec = cls()
        rec.stats = defaultdict(list, {k: list(v) for k, v in state["stats"].items()})
        rec.vae_losses = list(state["vae_losses"])
        rec.var_enc = list(state["var_enc"])
        rec.var_dec = list(state["var_dec"])
        rec.average_log_likelihoods = list(state["average_log_likelihoods"])
        rec.correlation_ratios = list(state["correlation_ratios"])
        rec.correlation_ratios_per_param = {
            k: list(v)
            for k, v in state.get("correlation_ratios_per_param", {}).items()
        }
        return rec

    def loss_trace(self) -> np.ndarray:
        if not self.vae_losses:
            return np.array([])
        return np.concatenate(self.vae_losses)

    def save_npz(self, dirname: str, final: bool = False) -> str:
        """Write losses.npz with the reference's channel layout."""
        payload: Dict[str, np.ndarray] = {}
        for stat, vals in self.stats.items():
            payload[stat] = np.asarray(vals)
        payload["VAE Loss"] = self.loss_trace()
        payload["Decoder Variance"] = np.asarray(self.var_dec)
        payload["Encoder Variance"] = np.asarray(self.var_enc)
        payload["EigenValues"] = np.zeros((2, 0))
        payload["Average Log Likelihood"] = np.asarray(self.average_log_likelihoods)
        if final:
            payload["Correlation Ratio"] = np.asarray(self.correlation_ratios)
            for path, vals in self.correlation_ratios_per_param.items():
                payload[f"Correlation Ratio/{path}"] = np.asarray(vals)
        # atomic: losses.npz is the run's primary artifact and is rewritten
        # at every plot cadence — a preemption mid-write must leave the
        # previous complete version, not a truncated zip
        fn = os.path.join(dirname, "losses.npz")
        tmp = os.path.join(dirname, f"losses.tmp.{os.getpid()}.npz")
        np.savez(tmp, **payload)
        os.replace(tmp, fn)
        return fn
