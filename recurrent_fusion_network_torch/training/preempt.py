"""Graceful-preemption guard for the training loops.

The port's copy of ``recurrent_fusion_network_tpu/training/preempt.py``,
for one process. Cluster schedulers announce preemption with SIGTERM and
grant a short grace window before SIGKILL. The trainers install a
``PreemptGuard``: the signal only sets a flag, the loop checks it at the
next iteration boundary, writes a regular (non-best) checkpoint with the
full infos / iterator state, and exits cleanly — a resume with
``--start_from`` loses at most one iteration.

Semantics:
  * SIGTERM sets the flag (async-signal-safe: no I/O in the handler).
  * A second SIGTERM restores the original dispositions, so a third one
    (an impatient supervisor) acts immediately.
  * ``close()`` restores the original handlers; the trainers call it in the
    loop epilogue so library callers' signal state is untouched.
  * Outside the main thread the handler stays uninstalled (CPython delivers
    signals only there, and ``signal.signal`` raises elsewhere).

``sync()`` is the flag read: the multi-host all-gather of the JAX package's
guard arrives with multi-host training (ROADMAP.md queue 1, M10). Disable
with ``--graceful_preempt 0`` (e.g. when a supervisor owns SIGTERM).
"""

from __future__ import annotations

import signal
import threading


class PreemptGuard:
    """Flag-setting SIGTERM handler with restore-on-close."""

    SIGNALS = (signal.SIGTERM,)

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.triggered = False
        self._installed = []

    @classmethod
    def from_opt(cls, opt) -> "PreemptGuard":
        return cls(enabled=bool(getattr(opt, "graceful_preempt", 1))).install()

    def install(self) -> "PreemptGuard":
        if not self.enabled:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.SIGNALS:
            old = signal.signal(sig, self._handler)
            self._installed.append((sig, old))
        return self

    def _handler(self, signum, frame):
        if self.triggered:
            # second signal: step aside so the next one acts immediately
            self.close()
        self.triggered = True

    def sync(self) -> bool:
        """Iteration-boundary check: whether SIGTERM has arrived."""
        return self.enabled and self.triggered

    def close(self):
        for sig, old in self._installed:
            signal.signal(sig, old)
        self._installed = []
