"""The port's profiling (``utils/profiling.py``) on the CPU: the tracer's
spans and counters (totals, counts, a bounded ring of records, exact under
two threads, a profiler range only while the thread is profiled,
collections as the span ``gc``); ``TraceWindow`` traces iterations
[start, start + steps) once per run, as a Chrome trace of CPU activity and
of every thread's ranges, inert without a directory or steps, and
``close()`` ends an open window; its options read as the JAX package's
do."""

import gc
import json
import os
import sys
import threading
import time

import pytest
import torch

from recurrent_fusion_network_torch.config import Options as TOpt
from recurrent_fusion_network_torch.utils import profiling as t_prof
from recurrent_fusion_network_tpu.config import Options as JOpt
from recurrent_fusion_network_tpu.utils import profiling as j_prof


def _iteration(i):
    with torch.profiler.record_function(f"iteration_{i}"):
        torch.ones(8, 8) @ torch.ones(8, 8)


def _events(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_window_traces_exactly_its_window_once(tmp_path, capsys):
    window = t_prof.TraceWindow(str(tmp_path), start=3, steps=2)
    for i in range(10):
        window.tick(i)
        _iteration(i)
    window.close()
    assert os.listdir(tmp_path) == ["trace_iters_3-4.json"]
    assert window.path == str(tmp_path / "trace_iters_3-4.json")
    names = _events(window.path)
    assert {"iteration_3", "iteration_4"} <= names
    assert not {f"iteration_{i}" for i in (0, 1, 2, 5, 6, 7, 8, 9)} & names
    assert capsys.readouterr().out == f"profiler trace written to {tmp_path}\n"


def test_close_ends_an_open_window(tmp_path):
    window = t_prof.TraceWindow(str(tmp_path), start=2, steps=5)
    for i in range(4):  # the run stops at iteration 3, inside the window
        window.tick(i)
        _iteration(i)
    assert window.active
    window.close()
    assert not window.active and not window.enabled
    assert os.listdir(tmp_path) == ["trace_iters_2-3.json"]
    assert {"iteration_2", "iteration_3"} <= _events(window.path)
    window.tick(4)
    window.close()
    assert os.listdir(tmp_path) == ["trace_iters_2-3.json"]


@pytest.mark.parametrize("log_dir, steps", [("", 3), ("set", 0)])
def test_trace_window_is_inert_without_a_directory_or_steps(tmp_path, log_dir, steps):
    d = str(tmp_path / log_dir) if log_dir else ""
    window = t_prof.TraceWindow(d, start=0, steps=steps)
    for i in range(4):
        window.tick(i)
    window.close()
    assert not window.enabled and window.path is None
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("flags", [{}, {"profile_dir": "p", "profile_start": 0,
                                        "profile_steps": 4},
                                   {"profile_dir": "p", "profile_start": None,
                                    "profile_steps": 2}])
def test_from_opt_reads_the_options_as_jax(flags):
    t = t_prof.TraceWindow.from_opt(TOpt(device="cpu", **flags))
    j = j_prof.TraceWindow.from_opt(JOpt(**flags))
    assert (t.log_dir, t.start, t.steps, t.enabled) == (j.log_dir, j.start, j.steps, j.enabled)
    assert t.cuda is False
    assert t_prof.TraceWindow.from_opt(TOpt(**flags)).cuda is True  # the run's default card


@pytest.fixture
def tracer():
    t_prof.reset()
    yield t_prof
    t_prof.reset()


def test_spans_and_counters_keep_totals_counts_and_records(tracer):
    t0 = time.perf_counter()
    for _ in range(2):
        with tracer.span("a"):
            time.sleep(0.002)
    tracer.count("b", 3)
    tracer.count("b", 4)
    with tracer.span("a") as s:
        s.drop()  # left out
    a, b = tracer.aggregate("a"), tracer.aggregate("b")
    assert a.count == 2 and len(a.records) == 2
    assert a.total == pytest.approx(sum(r.value for r in a.records)) and a.total >= 0.004
    assert t0 < a.records[0].end < a.records[1].end <= time.perf_counter()
    assert not any(r.on or r.traced for r in a.records + b.records)  # no profiler ran
    assert (a.traced_total, a.traced_count, b.traced_total, b.traced_count) == (0, 0, 0, 0)
    assert (b.total, b.count, [r.value for r in b.records]) == (7, 2, [3, 4])
    assert tracer.aggregate("missing") is None
    assert set(tracer.aggregates()) == {"a", "b"}
    tracer.reset()
    assert tracer.aggregates() == {}


def test_the_ring_keeps_the_last_records(tracer):
    n = tracer.RING + 5
    for i in range(n):
        tracer.count("c", i)
    c = tracer.aggregate("c")
    assert (c.count, c.total, len(c.records)) == (n, n * (n - 1) // 2, tracer.RING)
    assert c.records[0].value == 5 and c.records[-1].value == n - 1
    assert c.after(0) == c.after(5) == c.records
    assert [r.value for r in c.after(n - 2)] == [n - 2, n - 1]
    assert c.after(n) == ()


def test_threads_recording_at_once_lose_nothing(tracer):
    """More threads than cores, switching every microsecond, each recording
    into the same span and counter: no record is lost from the totals."""
    threads, n = 2 * (os.cpu_count() or 1), 4000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n):
            with tracer.span("s"):
                tracer.count("n", 1)

    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert tracer.aggregate("n")[:2] == (threads * n, threads * n)
    assert tracer.aggregate("s").count == threads * n


def test_a_span_is_a_range_only_while_its_thread_is_profiled(tracer, tmp_path, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a):
        opened.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with tracer.span("quiet"):
        pass
    assert opened == []  # no profiler: no range
    done = threading.Event()

    def worker():
        with tracer.span("worker"):
            pass
        done.set()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("main"):
            torch.ones(2) + 1
        threading.Thread(target=worker).start()
        done.wait(30)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = _events(tmp_path / "t.json")
    assert opened == ["main"] and "main" in names and "worker" not in names
    on = {n: [r[2:] for r in tracer.aggregate(n).records] for n in ("quiet", "main", "worker")}
    assert on == {"quiet": [(False, False)], "main": [(True, True)], "worker": [(False, True)]}


def test_the_traced_totals_hold_every_threads_records_while_a_profiler_runs(tracer):
    """A profiler started on the main thread (a benchmark's traced window):
    the records that other threads make while it runs, collections among
    them, count in the traced totals; those before and after it do not."""
    go, done = threading.Event(), threading.Event()

    def worker():  # started before the profiler
        go.wait(30)
        gc.collect()
        with tracer.span("w"):
            tracer.count("n", 10)
        done.set()

    tracer.count("n", 100)
    thread = threading.Thread(target=worker)
    thread.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        gc_before = tracer.aggregate("gc")
        go.set()
        assert done.wait(30)
    thread.join()
    tracer.count("n", 1000)
    n, w, collections = tracer.aggregate("n"), tracer.aggregate("w"), tracer.aggregate("gc")
    assert (n.traced_total, n.traced_count) == (10, 1)
    assert (n.total, n.count) == (1110, 3)
    assert (w.traced_count, w.count) == (1, 1) and w.traced_total == w.total > 0
    assert not w.records[0].on and w.records[0].traced
    before = gc_before.traced_count if gc_before else 0
    assert collections.traced_count >= before + 1


def test_trace_window_holds_a_worker_threads_range(tracer, tmp_path):
    """A thread started before the window: its span is a range of the
    window's trace, beside the main thread's, and its record reads on."""
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(30)
        with tracer.span("worker.batch"):
            torch.ones(4) * 2
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()
    window = t_prof.TraceWindow(str(tmp_path), start=1, steps=2)
    for i in range(4):
        window.tick(i)
        if i == 1:
            go.set()
            assert done.wait(30)
        _iteration(i)
    window.close()
    thread.join()
    names = _events(window.path)
    assert {"worker.batch", "iteration_1", "iteration_2"} <= names
    assert [r.on for r in tracer.aggregate("worker.batch").records] == [True]


def test_collections_are_the_span_gc(tracer):
    gc.collect()
    assert tracer.aggregate("gc").count >= 1


def test_trace_window_says_when_it_recorded_no_device_event(tmp_path, capsys, monkeypatch):
    """A window on the card that recorded no device event warns on
    standard error; a torch without the all-threads option says once that
    the trace holds the main thread only."""
    real = t_prof._profiler
    monkeypatch.setattr(t_prof, "_profiler", lambda cuda: real(False))  # no card here
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(t_prof, "_all_threads_config", lambda: None)
    monkeypatch.setattr(t_prof, "_told_main_thread_only", False)
    for k in range(2):
        window = t_prof.TraceWindow(str(tmp_path / str(k)), start=0, steps=1, cuda=True)
        window.tick(0)
        _iteration(0)
        window.close()
        out = capsys.readouterr()
        assert out.out == f"profiler trace written to {tmp_path / str(k)}\n"
        assert "recorded no device event" in out.err
        assert ("main thread's ranges only" in out.err) == (k == 0)
