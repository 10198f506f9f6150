"""Metric logging: ``metrics.jsonl``, a text line, and TensorBoard.

Counterpart of ``bevfusion_tpu/utils/logging.py`` (reference:
TextLoggerHook + TensorboardLoggerHook every 50 iterations,
configs/default.yaml:8-14): the same records, keys and text line. Two
differences: the values are taken as floats only at the logging interval,
so a step between two log lines reads nothing back from the card; and the
JAX logger's guard on ``diag/window_overflow`` has nothing to read, since
the port's rulebooks drop no neighbor pair (``runtime/train.py``).
TensorBoard is written where ``torch.utils.tensorboard`` imports and the
caller asks for it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, run_dir: str, interval: int = 50, tensorboard: bool = True):
        self.run_dir = run_dir
        self.interval = interval
        self._t0 = time.time()
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except Exception:
                pass

    def _write(self, rec: Dict[str, Any], scal: Dict[str, float], step: int, prefix: str,
               head: str) -> None:
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scal.items():
                self._tb.add_scalar(prefix + k, v, step)
        msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(scal.items())[:8])
        print(f"[{head}] {msg}", flush=True)

    def log(self, epoch: int, it: int, steps_per_epoch: int, logs: Dict[str, Any]) -> None:
        """One train step's ``logs`` (tensors or numbers), recorded every
        ``interval`` iterations of an epoch."""
        if it % self.interval:
            return
        step = epoch * steps_per_epoch + it
        scal = {k: float(v) for k, v in logs.items()}
        rec = {"epoch": epoch, "iter": it, "step": step,
               "time": round(time.time() - self._t0, 1), **scal}
        self._write(rec, scal, step, "", f"E{epoch} {it}/{steps_per_epoch}")

    def log_eval(self, epoch: int, metrics: Dict[str, Any]) -> None:
        """Per-epoch val metrics (the DistEvalHook log line)."""
        scal = {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}
        rec = {"epoch": epoch, "eval": True, "time": round(time.time() - self._t0, 1), **scal}
        self._write(rec, scal, epoch, "val/", f"E{epoch} eval")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
