"""Tiny cells driven end to end on the CPU (the kernels' plain versions
stand in for the CUDA kernels), the guards of a run, and the faults and
the control that the comparison has to catch."""

import ast
import json
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from portbench import run
from portbench.harness import env
from portbench.harness.env import ROOT
from portbench.harness.job import Job
from portbench.tests import tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def metrics_of(workload):
    e2e = [m for m in BENCH["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in BENCH["per_layer"] if workload in m.get("workloads", [workload])]
    return e2e, layer


NAMES = {"xe": ("xe-400x5-f32", "rfnet-xe-train"),
         "scst": ("scst-400x5-f32", "rfnet-scst-train"),
         "decode": ("backlog-b512-beam3-bf16", "reviewnet-decode-b512")}


def execute(kind, model, *, trace=False, check="", dtype=None, seed=2 ** 31 + 7,
            limits=tiny.LIMITS):
    name, workload = NAMES[kind]
    traffic = tiny.traffic(name)
    if dtype:
        traffic["dtype"] = dtype
    job = Job(workload=workload, config=tiny.config(model), traffic=traffic, seed=seed,
              seconds=1.0, trace=trace, device="cpu", t_start=time.time(), check=check)
    return run.execute(job, limits, *metrics_of(workload), platform="cpu")


def test_tiny_xe_cell_prints_the_result_line():
    result, lines = execute("xe", "recurrent_fusion_model")
    assert set(result) == KEYS | {"checks", "calibration"}
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert set(result["metrics"]) == {"xe_images_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert len(lines) == len(result["checks"])


def test_tiny_traced_xe_cell_reads_its_per_layer_metrics():
    result, _ = execute("xe", "recurrent_fusion_model", trace=True)
    assert set(result) == KEYS | {"breakdown", "checks", "calibration"}
    assert result["correct"] is True
    assert {"launches.xe", "device_idle.xe", "mfu.xe", "loader_wait_ms.xe"} <= set(
        result["metrics"])
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["device_ops"]) <= 10


@pytest.mark.parametrize("model", ["recurrent_fusion_model", "review_net"])
def test_tiny_decode_cell_in_f32_is_correct(model):
    result, _ = execute("decode", model, dtype="float32")
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]["captions_per_s"]["value"] > 0


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_compared_number_has_a_limit_in_the_cell(w):
    limits = run.load_cell(w["name"])[3]
    kind = {"xe": "xe", "scst": "scst", "decode": "decode"}[tiny.traffic(w["traffic"])["kind"]]
    model = tiny.config_of(w["config"])
    result, _ = execute(kind, model, limits=limits)
    assert set(result["checks"]) - {"tf32_flags_changed"} == set(limits)


def test_bf16_run_of_the_f32_cell_fails_the_comparison():
    result, _ = execute("xe", "recurrent_fusion_model", dtype="bfloat16")
    assert result["correct"] is False
    assert result["checks"]["loss_gap"]["value"] > result["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "halfbatch"])
def test_xe_faults_are_caught(fault):
    result, _ = execute("xe", "recurrent_fusion_model", check=f"fault:{fault}")
    assert result["correct"] is False


def test_tiny_scst_cell_is_correct():
    result, _ = execute("scst", "recurrent_fusion_model")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"scst_images_per_s", "setup_s"}
    assert {"rollout_gap", "reward_gap", "loss_gap"} <= set(result["checks"])


@pytest.mark.parametrize("fault", ["unchanged", "halfbatch", "token", "reward"])
def test_scst_faults_are_caught(fault):
    result, _ = execute("scst", "recurrent_fusion_model", check=f"fault:{fault}")
    assert result["correct"] is False


# at the tiny widths the captions barely depend on the image, so greedy and
# beam-3 decoding give the same caption for every image on some seeds (the
# default one among them) and part on most images on others, as on this one
GREEDY_PARTS = 2 ** 31 + 8


@pytest.mark.parametrize("fault,number,seed", [("altered", "lp_gap", 2 ** 31 + 7),
                                               ("state", "lp_gap", 2 ** 31 + 7),
                                               ("greedy", "beam_gap", GREEDY_PARTS)])
def test_decode_faults_are_caught(fault, number, seed):
    result, _ = execute("decode", "recurrent_fusion_model", dtype="float32",
                        check=f"fault:{fault}", seed=seed)
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


@pytest.mark.parametrize("kind,dtype", [("xe", None), ("scst", None), ("decode", "float32")])
def test_the_control_in_the_programs_place_is_not_correct(kind, dtype):
    result, _ = execute(kind, "recurrent_fusion_model", check="control", dtype=dtype)
    assert result["correct"] is False
    program = result["calibration"]["program"]
    assert all(v <= tiny.LIMITS[k] for k, v in program.items()), program


def test_a_changed_precision_flag_fails_the_run():
    from portbench.kinds import xe

    real = xe.run

    def flips(job):
        out = real(job)
        torch.backends.cuda.matmul.allow_tf32 = True
        return out

    try:
        with mock.patch.object(xe, "run", flips):
            result, _ = execute("xe", "recurrent_fusion_model")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert result["checks"]["tf32_flags_changed"]["value"] == 1.0
    assert result["correct"] is False


def test_forbidden_modules_compare_whole_top_level_names():
    found = env.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                   "recurrent_fusion_network_tpu.models", "numpy"])
    assert found == ["flax", "jax", "jaxlib", "recurrent_fusion_network_tpu"]
    assert env.forbidden_modules(["recurrent_fusion_network_torch.models", "jaxtyping",
                                  "portbench.run"]) == []


def test_reference_imports_nothing_of_the_port():
    allowed = {"torch", "numpy", "statistics", "math", "collections", "__future__"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert all(n.split(".")[0] in allowed for n in names), (path.name, names)
    code = ("import sys, portbench.reference.xe, portbench.reference.models, "
            "portbench.reference.scst, portbench.reference.cider, "
            "portbench.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'recurrent_fusion_network_tpu', "
            "'recurrent_fusion_network_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_command_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "rfnet-xe-train",
                        "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_command_without_the_port_exits_without_a_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "rfnet-xe-train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card_is_correct(card, workload):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                        "--seed", str(2 ** 31 + 99), "--seconds", "5", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["kind"] == card
