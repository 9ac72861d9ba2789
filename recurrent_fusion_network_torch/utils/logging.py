"""Structured training logs.

The port's copy of ``JsonlLogger`` and ``MetricsLog`` from
``recurrent_fusion_network_tpu/utils/logging.py``. The reference logs by
printing to stdout and by stashing history dicts into infos.pkl
(train.py:173-177); the JSONL sink (``--json_log``) makes runs
machine-readable without parsing stdout, and ``MetricsLog`` keeps the
history dicts under the infos.pkl keys.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class JsonlLogger:
    """Append-only JSONL event log."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, **event):
        event.setdefault("ts", time.time())
        if self._f:
            try:
                self._f.write(json.dumps(event) + "\n")
                self._f.flush()
            except (OSError, ValueError):
                # telemetry must never kill training (disk full, closed
                # fd): disable the sink and keep going — the reference
                # only ever printed to stdout
                import warnings

                warnings.warn("JSONL log sink failed; disabling it")
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class MetricsLog:
    """In-memory history dicts with the reference's infos.pkl keys."""

    def __init__(self):
        self.loss_history = {}
        self.lr_history = {}
        self.ss_prob_history = {}
        self.val_result_history = {}

    def record_train(self, iteration, loss, lr, ss_prob=0.0):
        self.loss_history[iteration] = loss
        self.lr_history[iteration] = lr
        self.ss_prob_history[iteration] = ss_prob

    def record_val(self, iteration, loss, lang_stats, predictions):
        self.val_result_history[iteration] = {
            "loss": loss, "lang_stats": lang_stats, "predictions": predictions}

    def as_infos(self):
        return {"loss_history": self.loss_history, "lr_history": self.lr_history,
                "ss_prob_history": self.ss_prob_history,
                "val_result_history": self.val_result_history}
