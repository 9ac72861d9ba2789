"""Structured training logs.

The port's copy of ``JsonlLogger`` from
``recurrent_fusion_network_tpu/utils/logging.py``. The reference logs by
printing to stdout and by stashing history dicts into infos.pkl
(train.py:173-177); the JSONL sink (``--json_log``) makes runs
machine-readable without parsing stdout.
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

