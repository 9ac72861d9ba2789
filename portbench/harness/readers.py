"""The per-layer metric readers, found by name: ``portbench/metrics/<name>.py``
defines ``read(ctx)``."""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field

from .env import ROOT

METRICS = ROOT / "portbench" / "metrics"


@dataclass
class Context:
    summary: dict                 # harness/trace.py::Window.summary
    spans: object                 # harness/trace.py::Spans
    counts: dict                  # units (steps or batches) done in the window, launches
    config: dict
    traffic: dict
    extra: dict = field(default_factory=dict)


def load(name: str):
    path = METRICS / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader {path} for the per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(metrics, ctx: Context) -> dict:
    """{name: {"value", "unit"}} of the readers that found something."""
    out = {}
    for m in metrics:
        value = load(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
