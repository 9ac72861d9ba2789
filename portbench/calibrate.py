"""Run cells several times, one process each as the driver runs them, and
keep every result line: the readings that the limits and the bounds are
set from.

    python3 -m portbench.calibrate OUT.jsonl WORKLOAD SECONDS TRACE CHECK SEED [SEED ...]

Each run's result line (or its failure: exit code and the end of its
standard error) is appended to OUT.jsonl with the arguments it ran with,
and a one-line digest goes to standard output. CHECK is "-" for none, or
"control" / "fault:<name>".
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def main(argv) -> int:
    out, workload, seconds, trace, check, *seeds = argv
    for seed in seeds:
        cmd = [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", seed,
               "--seconds", seconds, "--trace", trace]
        if check != "-":
            cmd += ["--check", check]
        t0 = time.time()
        p = subprocess.run(cmd, capture_output=True, text=True)
        rec = {"workload": workload, "seed": int(seed), "seconds": float(seconds),
               "trace": int(trace), "check": check, "rc": p.returncode,
               "wall_s": time.time() - t0}
        lines = p.stdout.strip().splitlines()
        try:
            rec["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            rec["stdout"] = p.stdout[-2000:]
        rec["stderr"] = p.stderr[-6000:]
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        r = rec.get("result", {})
        digest = {k: round(v["value"], 4) for k, v in r.get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in r.get("checks", {}).items()}
        print(workload, seed, trace, check, "rc", p.returncode, "correct", r.get("correct"),
              digest, checks, r.get("calibration", {}).get("control"),
              "peak", r.get("device", {}).get("memory_peak_bytes"),
              "wall", round(rec["wall_s"], 1), flush=True)
        if "result" not in rec:
            print(rec["stderr"][-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
