"""Host spans and the profiler window of a ``--trace 1`` run.

``Spans`` times the benchmark's own calls into the program's layers
(``loader``, ``submit``, ...) on the host clock and, while a profiler
runs, marks them as ``torch.profiler.record_function`` ranges, so that the
device's idle gaps can be named by what the host was doing.

``Window`` runs ``torch.profiler`` (CPU and CUDA activities) over a traced
window, exports the Chrome trace to a temporary file under ``TMPDIR``,
reads it and deletes it. From the device events inside the window it
gives: the busy time (the union of kernel, copy and set intervals), the
kernels (name, start, duration), the idle gaps named by the innermost
benchmark span around each, and the ``breakdown`` the result line
carries. On the CPU (the tests) the top-level CPU operators stand in for
device events.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


class Spans:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.on = False  # time spans only inside a traced window
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1

    def mean(self, name: str):
        n = self.counts.get(name, 0)
        return self.totals[name] / n if n else None


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Window:
    """One traced window: ``start()``, the work, ``stop()``, then read
    ``summary``."""

    def __init__(self, spans: Spans, default: str, cpu: bool = False):
        # default: what the host does outside every span (the loop itself)
        self.spans, self.default, self.cpu = spans, default, cpu
        self.summary = None

    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU] + ([] if self.cpu else [ProfilerActivity.CUDA])

    def prepare(self):
        """Start and stop the profiler once at set-up, around one kernel, so
        that the device tracer is running before the window opens (a short
        window missed every kernel otherwise)."""
        import torch
        from torch.profiler import profile

        with profile(activities=self._activities()):
            if not self.cpu:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self):
        import torch
        from torch.profiler import profile

        self.prof = profile(activities=self._activities())
        self.prof.start()
        self.spans.on = True
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        self.window_host_s = time.perf_counter() - self.t0
        self._range.__exit__(None, None, None)
        self.spans.on = False
        if not self.cpu:
            torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        del self.prof
        self.summary = self._read(events)
        return self.summary

    def _read(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window range")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        if self.cpu:  # top-level operators stand in for the device
            dev = [e for e in xs if e.get("cat") == "cpu_op"]
        else:
            dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
        dev = [(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])), e)
               for e in dev]
        dev = [d for d in dev if d[1] > d[0]]
        if not dev:
            cats = defaultdict(int)
            for e in xs:
                cats[e.get("cat")] += 1
            raise RuntimeError(f"no device event inside the traced window [{w0}, {w1}] us; "
                               f"the trace's events by category: {dict(cats)}")
        busy = _union([(a, b) for a, b, _ in dev])
        busy_us = sum(b - a for a, b in busy)
        kernels = [(e["name"], a, b - a) for a, b, e in dev
                   if self.cpu or e.get("cat") == "kernel"]
        by_name = defaultdict(float)
        for a, b, e in dev:
            by_name[e["name"]] += (b - a) / 1e6
        names = set(self.spans.totals)
        host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                if e.get("cat") == "user_annotation" and e.get("name") in names]
        gaps = defaultdict(float)
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            around = [h for h in host if h[0] <= mid <= h[1]]
            name = min(around, key=lambda h: h[1] - h[0])[2] if around else self.default
            gaps[name] += (b - a) / 1e6
        top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
        return {
            "window_s": (w1 - w0) / 1e6,
            "busy_s": busy_us / 1e6,
            "kernels": kernels,
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
        }
