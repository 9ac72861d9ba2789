"""What a kind's driver gets: the cell's configuration and traffic, the
run's arguments, the device, the host spans, and the time the process
started."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

from .trace import Spans


class WindowClosed(Exception):
    """Raised by a driver's hook to end the program's loop at the window's
    close."""


@dataclass
class Job:
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str              # "cuda" on the chip; "cpu" only in the tests
    t_start: float           # time.time() at process start
    check: str = ""          # "", "control" or "fault:<name>" (calibration and tests)
    spans: Spans = field(default_factory=Spans)

    def mark(self, what: str) -> None:
        """Note on standard error when a phase of the set-up ended."""
        print(f"portbench: {what} at {time.time() - self.t_start:.3f} s", file=sys.stderr,
              flush=True)


@dataclass
class Outcome:
    e2e: dict                # host-clock end-to-end metrics, by name (setup_s among them)
    attempted: int
    failed: int
    numbers: dict            # the compared numbers, by name
    memory_peak_bytes: int
    summary: dict = None     # the traced window's (trace.Window.summary)
    counts: dict = field(default_factory=dict)
    calibration: dict = field(default_factory=dict)  # control / fault readings
