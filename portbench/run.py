"""Run one cell of ``BENCHMARK.json`` once and print one JSON result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``portbench/configs/<config>.json``) and a
traffic mix (``portbench/traffic/<mix>.json``), whose ``kind`` names the
driver (``portbench/kinds/<kind>.py``); its limits are
``portbench/limits/<cell>.json`` and its per-layer metrics are read by
``portbench/metrics/<metric>.py``. With ``--trace 0`` the line carries the
cell's end-to-end metrics (host clock), with ``--trace 1`` its per-layer
ones (a profiled window) and ``breakdown``. Every run compares what the
timed path produced with the plain reference (``portbench/reference``)
and prints each compared number beside its limit, last on standard error
and last in the line (``checks``).

Exits non-zero without a result line when there is no CUDA card (or fewer
than the cell asks for), when the port is not in the checkout, or when a
module of JAX or of the JAX package was loaded. ``--check control`` or
``--check fault:<name>`` (calibration and tests only) add the control's
readings or plant a fault.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench.harness import env  # noqa: E402


def load_cell(workload: str, root=None):
    """-> (cell entry, configuration, traffic, limits, end-to-end metrics,
    per-layer metrics) of ``workload``, found by name."""
    root = root or env.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    base = root / "portbench"
    config = json.loads((base / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return cell, config, traffic, limits, e2e, layer


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--check", default="", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def execute(job, limits, e2e_metrics, layer_metrics, *, platform="gpu", count=1):
    """Run the job's driver, judge it, and return (result dict, lines for
    standard error). ``count``: the cards the run uses."""
    import torch

    from portbench.harness.readers import Context, read_all

    f32 = job.traffic["dtype"] == "float32"
    if f32:
        env.pin_ieee_f32(torch)
    driver = importlib.import_module(f"portbench.kinds.{job.traffic['kind']}")
    out = driver.run(job)
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in out.numbers.items()}
    if f32:
        checks["tf32_flags_changed"] = {"value": float(not env.ieee_f32_pinned(torch)),
                                        "limit": 0.0}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and out.failed == 0
    if job.trace:
        if not out.summary or not out.summary["kernels"]:
            raise RuntimeError("the traced window recorded no kernel")
        ctx = Context(out.summary, job.spans, out.counts, job.config, job.traffic)
        metrics = read_all(layer_metrics, ctx)
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
                   for m in e2e_metrics}
    device = {"platform": platform,
              "kind": torch.cuda.get_device_name(0) if platform == "gpu" else "cpu",
              "count": count, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": device}
    if job.trace:
        device["busy_s"] = out.summary["busy_s"]
        device["window_s"] = out.summary["window_s"]
        result["breakdown"] = out.summary["breakdown"]
    if out.calibration:
        result["calibration"] = out.calibration
    result["checks"] = checks  # last: the numbers compared, each beside its limit
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    from portbench.harness.job import Job

    args = parse(argv)
    if not env.port_present():
        print(f"portbench: the port ({env.PORT}) is not in this checkout", file=sys.stderr)
        return 2
    env.set_cache_dirs()
    cell, config, traffic, limits, e2e, layer = load_cell(args.workload)
    import torch

    why = env.chip_check(torch, cell["chips"])
    if why:
        print(f"portbench: no chip for {args.workload}: {why}", file=sys.stderr)
        return 3
    job = Job(workload=args.workload, config=config, traffic=traffic, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device="cuda",
              t_start=T_START, check=args.check)
    result, lines = execute(job, limits, e2e, layer, count=cell["chips"])
    found = env.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
