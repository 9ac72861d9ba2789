"""BENCHMARK.json against the contract it is checked by, and every name
in it resolved to its files."""

import json
import re

import pytest

from portbench.harness.env import ROOT
from portbench.run import load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|"
                   r"experts_per|_size$)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    cell, config, traffic, limits, e2e, layer = load_cell(w["name"])
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    assert config["name"] == w["config"]
    assert (ROOT / "portbench" / "kinds" / f"{traffic['kind']}.py").exists()
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in [x["name"] for x in e2e]
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
    assert not any(WIDTH.search(k) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metrics_entries():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], m["layer"])
        for w in m.get("workloads", []):
            assert w in [x["name"] for x in BENCH["workloads"]]


def test_flagship_counts_its_published_parameters():
    from portbench.harness.job import Job
    from portbench.harness.weights import count
    from portbench.kinds.common import model_layout, options

    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        _, layout = model_layout(options(Job("x", cfg, {}, 1, 1.0, False, "cpu", 0.0)), "meta")
        if "parameters" in cfg:
            assert count(layout) == cfg["parameters"]


def test_attention_reads_per_unit():
    from portbench.harness.model_math import per_unit

    def cfg(name):
        return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())

    xe = json.loads((ROOT / "portbench" / "traffic" / "xe-400x5-f32.json").read_text())
    dec = json.loads((ROOT / "portbench" / "traffic" / "backlog-b512-beam3-bf16.json").read_text())
    # the launches the port's counters read on these paths (PERF.md's kernel table)
    assert per_unit(cfg("rfnet-flagship"), xe)["fwd_launches"] == 65
    assert per_unit(cfg("rfnet-flagship"), xe)["bwd_launches"] == 65
    assert per_unit(cfg("rfnet-flagship"), dec)["fwd_launches"] == 64
    assert per_unit(cfg("reviewnet-inception-v3"), dec)["fwd_launches"] == 24
