"""Profiling: the program's spans and counters, and the operator's trace.

Spans and counters (``span(name)``, ``count(name, n)``) are always on.
For each name the tracer keeps a total and a count, the same of the
records made while a profiler ran in the process (on any thread: a traced
window), and a ring of the last ``RING`` records, each (duration in s or
increment, its ``time.perf_counter()`` end, whether a profiler was
recording the recording thread, whether one ran in the process). A record
costs O(1): the totals are kept per thread, so a record takes no lock
beyond the GIL. While a profiler records the calling thread, a span is
also a ``torch.profiler.record_function`` range, so it lands in the same
Chrome trace as the kernels and copies.
Interpreter collections are the span ``gc`` (a ``gc.callbacks`` hook).
``aggregate(name)`` / ``aggregates()`` read them, ``reset()`` clears them.
PERF.md's "Spans and counters" table names every span and counter, where
it is recorded and what reads it.

``TraceWindow`` captures a ``torch.profiler`` trace where the JAX package
captures a ``jax.profiler`` one. The file differs by nature: the JAX
package writes an xprof / TensorBoard profile (``*.xplane.pb``), the port a
Chrome trace (``*.json``, chrome://tracing or Perfetto), with the CUDA
kernels (``additive_attention_fwd`` / ``_bwd`` among them) on the device
rows when the run is on the card, and the ranges of every thread (the
loader's prefetch thread, the server's worker) where the installed torch
can profile all threads.
"""

from __future__ import annotations

import gc
import os
import sys
from collections import deque
from threading import get_ident
from time import perf_counter
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 4096  # the recent records kept for each name

_thread_profiled = torch.autograd._profiler_enabled  # thread-local in torch
_all_threads = False  # a TraceWindow profiles every thread


def _traced() -> bool:
    """A profiler runs in this process, on whichever thread started it."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class Record(NamedTuple):
    value: float   # seconds of a span, or a counter's increment
    end: float     # time.perf_counter() at its end
    on: bool       # a profiler was recording the recording thread
    traced: bool   # a profiler ran in the process at its end


class Aggregate(NamedTuple):
    total: float
    count: int
    traced_total: float  # of the records made while a profiler ran
    traced_count: int
    records: Tuple[Record, ...]  # the last RING, oldest first

    def after(self, n: int) -> Tuple[Record, ...]:
        """The records from the ``n``-th (0: the first since the last
        reset) on, those still in the ring."""
        first = self.count - len(self.records)
        return self.records[max(0, n - first):]


class _Series:
    __slots__ = ("shards", "ring")

    def __init__(self):
        # thread ident -> [total, count, traced total, traced count]
        self.shards: Dict[int, list] = {}
        self.ring: deque = deque(maxlen=RING)


_series: Dict[str, _Series] = {}


def _record(name: str, value, end: float, on: bool) -> None:
    s = _series.get(name)
    if s is None:
        s = _series.setdefault(name, _Series())
    ident = get_ident()
    shard = s.shards.get(ident)
    if shard is None:  # only this thread writes its shard
        shard = s.shards[ident] = [0, 0, 0, 0]
    shard[0] += value
    shard[1] += 1
    traced = on or _traced()
    if traced:
        shard[2] += value
        shard[3] += 1
    s.ring.append((value, end, on, traced))


def _profiled() -> bool:
    return _all_threads or _thread_profiled()


class span:
    """``with span(name):`` records the block's host time under ``name``
    (and is a profiler range while the thread is profiled). ``drop()``
    inside the block leaves this one out of the aggregates."""

    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _all_threads or _thread_profiled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        else:
            self.range = None
        self.t0 = perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = perf_counter()
        profiled = self.range is not None
        if profiled:
            self.range.__exit__(None, None, None)
        if self.name is not None:
            _record(self.name, t1 - self.t0, t1, profiled)
        return False

    def drop(self) -> None:
        self.name = None  # the range, if open, keeps its own name


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name``: an increment, or seconds that the
    caller timed itself (``serve.submit``, timed on the client's thread and
    recorded by the server's worker)."""
    _record(name, n, perf_counter(), _profiled())


def aggregate(name: str) -> Optional[Aggregate]:
    """A copy of ``name``'s aggregates, or None before its first record."""
    s = _series.get(name)
    if s is None:
        return None
    shards = list(s.shards.values())
    ring = list(s.ring)
    return Aggregate(*(sum(x[i] for x in shards) for i in range(4)),
                     tuple(Record(*r) for r in ring))


def aggregates() -> Dict[str, Aggregate]:
    return {name: aggregate(name) for name in list(_series)}


def reset() -> None:
    _series.clear()


class _GcSpan:
    """Interpreter collections as the span ``gc``: a collection starts and
    stops on one thread, and never nests."""

    def __init__(self):
        self.t0, self.on, self.range = 0.0, False, None

    def __call__(self, phase, _info):
        if phase == "start":
            self.on = _profiled()
            if self.on:
                self.range = torch.profiler.record_function("gc")
                self.range.__enter__()
            self.t0 = perf_counter()
            return
        t1 = perf_counter()
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        _record("gc", t1 - self.t0, t1, self.on)


if not any(isinstance(cb, _GcSpan) for cb in gc.callbacks):
    gc.callbacks.append(_GcSpan())


def _all_threads_config():
    """The profiler's option to record every thread's ranges, or None
    where the installed torch has none."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


_told_main_thread_only = False


def _profiler(cuda: bool):
    """(a profiler to start, whether it records every thread)."""
    global _told_main_thread_only
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    config = _all_threads_config()
    if config is None:
        if not _told_main_thread_only:
            print(f"profiler: torch {torch.__version__} cannot profile every thread; the "
                  "trace holds the main thread's ranges only", file=sys.stderr)
            _told_main_thread_only = True
        return torch.profiler.profile(activities=activities), False
    return torch.profiler.profile(activities=activities, experimental_config=config), True


def _device_events(prof) -> int:
    results = prof.profiler.kineto_results
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in results.events() if e.device_type() == cuda)


class TraceWindow:
    """Capture a trace of training iterations [start, start + steps), once
    per run, into ``log_dir/trace_iters_{start}-{last}.json``. Driven by
    --profile_dir / --profile_start / --profile_steps: ``tick(iteration)``
    at the top of each loop iteration, ``close()`` on exit. Inert when
    steps == 0 or log_dir is empty. ``cuda``: record the device's kernels
    too (the run is on the card), and warn when the window recorded none."""

    def __init__(self, log_dir: str, start: int, steps: int, *, cuda: bool = False):
        self.log_dir, self.start, self.steps, self.cuda = log_dir, start, steps, cuda
        self.enabled = bool(log_dir) and steps > 0
        self.active = False
        self.path = None

    @classmethod
    def from_opt(cls, opt):
        return cls(getattr(opt, "profile_dir", "") or "",
                   int(getattr(opt, "profile_start", 5) or 0),
                   int(getattr(opt, "profile_steps", 0) or 0),
                   cuda=str(getattr(opt, "device", "cuda")).startswith("cuda"))

    def tick(self, iteration: int) -> None:
        global _all_threads
        if not self.enabled:
            return
        if not self.active and iteration >= self.start:
            self._prof, every = _profiler(self.cuda)
            self._prof.start()
            _all_threads = every
            self.active = True
            self._first, self._stop_at = iteration, iteration + self.steps
        elif self.active and iteration >= self._stop_at:
            self._finish()
        if self.active:
            self._last = iteration

    def close(self) -> None:
        """End an open window (the run stopped inside it)."""
        if self.active:
            self._finish()

    def _finish(self) -> None:
        global _all_threads
        if self.cuda:  # the window's kernels end, and are recorded, before the trace does
            torch.cuda.synchronize()
        _all_threads = False
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir,
                                 f"trace_iters_{self._first}-{self._last}.json")
        self._prof.export_chrome_trace(self.path)
        if self.cuda and not _device_events(self._prof):
            print(f"profiler: the window of iterations {self._first}-{self._last} recorded "
                  "no device event (a profiler late in a long process can miss them)",
                  file=sys.stderr)
        self._prof = None
        self.active = False
        self.enabled = False  # one window per run
        print(f"profiler trace written to {self.log_dir}")
