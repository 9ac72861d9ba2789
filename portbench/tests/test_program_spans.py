"""The readers of the program's own spans and counters
(``metrics/_program.py``) in the tiny traced cells on the CPU: every new
metric that has a CPU path reads a value, each beside its twin from the
benchmark's own spans where one nests the other."""

import pytest
import torch

from portbench.harness.readers import Context, load
from portbench.tests import tiny
from portbench.tests.test_bench_runs import NAMES, execute
from recurrent_fusion_network_torch.utils import profiling

SPANS = {"xe": {"fetch_wait_ms.xe", "dispatch_ms.xe", "gc_ms.xe"},
         "scst": {"dispatch_ms.scst", "reward_prep_ms.scst", "reward_native_ms.scst"},
         "decode": {"ingest_us.decode", "gather_wait_ms.decode", "assemble_ms.decode"}}


def traced(kind, **kw):
    profiling.reset()  # the tracer is the process's: readers see this run alone
    result, _ = execute(kind, "recurrent_fusion_model", trace=True, **kw)
    assert result["correct"] is True
    return {k: v["value"] for k, v in result["metrics"].items()}


def test_traced_xe_cell_reads_the_loader_and_step_spans():
    m = traced("xe")
    assert SPANS["xe"] <= set(m)
    assert "h2d_gb.xe" not in m  # the CPU copies nothing
    assert 0 < m["fetch_wait_ms.xe"] <= m["loader_wait_ms.xe"]
    assert m["dispatch_ms.xe"] > 0 and m["gc_ms.xe"] >= 0


def test_traced_scst_cell_splits_the_reward():
    m = traced("scst")
    native = profiling.aggregate("reward.native") is not None
    assert SPANS["scst"] - ({"reward_native_ms.scst"} if not native else set()) <= set(m)
    assert m["dispatch_ms.scst"] > 0
    split = m["reward_prep_ms.scst"] + m.get("reward_native_ms.scst", 0.0)
    assert 0 < split <= m["reward_ms.scst"]


def test_decode_cell_readers_read_the_server_spans_of_the_window_alone():
    """The serving cell's window profiles the main thread, which on the CPU
    runs no operator (the worker decodes), so the harness cannot trace it
    here. A profiler around a whole untraced run stands in for the window:
    its readers then read every request and batch of the run; without it
    they read nothing, since no record was made in a window."""
    traffic = tiny.traffic(NAMES["decode"][0])
    ctx = Context(None, None, {}, tiny.config("recurrent_fusion_model"), traffic)
    profiling.reset()
    result, _ = execute("decode", "recurrent_fusion_model", dtype="float32")
    assert result["correct"] is True
    assert profiling.aggregate("serve.submit").count >= result["attempted"]
    assert all(load(name)(ctx) is None for name in SPANS["decode"])
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        result, _ = execute("decode", "recurrent_fusion_model", dtype="float32")
    assert result["correct"] is True
    m = {name: load(name)(ctx) for name in SPANS["decode"]}
    assert all(v is not None and v > 0 for v in m.values()), m
    submit = profiling.aggregate("serve.submit")
    assert submit.traced_count == submit.count >= result["attempted"]
    assert m["ingest_us.decode"] == pytest.approx(1e6 * submit.total / submit.count)
    with pytest.MonkeyPatch.context() as mp:  # a program that keeps no spans
        mp.delattr(profiling, "aggregate")
        assert all(load(name)(ctx) is None for name in SPANS["decode"])


@pytest.mark.parametrize("kind", ["xe", "scst"])
def test_readers_of_a_program_without_the_tracer_read_nothing(kind, monkeypatch):
    """On a checkout whose program keeps no spans the new metrics are left
    out of the line, and the rest of it stands."""
    monkeypatch.delattr(profiling, "aggregate")
    m = traced(kind)
    assert not SPANS[kind] & set(m) and m
