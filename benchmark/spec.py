"""What the benchmark runs, found by name: a cell of `BENCHMARK.json`
names its configuration (`benchmark/configs/<name>.json`) and its traffic
mix (`benchmark/traffic/<name>.json`); every metric has a reader of its
own (`benchmark/metrics/<name>.py`, a function `read(ctx)` that returns a
number or None); the limits of a cell's correctness check sit in
`benchmark/limits/<workload>.json`. Adding a cell, a configuration, a mix
or a metric therefore takes new files and new entries only."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""
    name: str
    chips: int
    config: dict            # benchmark/configs/<config>.json
    traffic: dict           # benchmark/traffic/<traffic>.json
    end_to_end: list        # BENCHMARK.json end_to_end entries it reports
    per_layer: list         # per_layer entries it reports
    limits: dict            # benchmark/limits/<name>.json ("numbers")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, bench: dict | None = None,
         here: str = HERE) -> Cell:
    """The cell named `workload` of `bench` (default: BENCHMARK.json at the
    root of the checkout), its files read from `here`."""
    bench = benchmark_file() if bench is None else bench
    rows = [w for w in bench["workloads"] if w["name"] == workload]
    if not rows:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {[w['name'] for w in bench['workloads']]}")
    w = rows[0]
    cfg = load_json(os.path.join(here, "configs", w["config"] + ".json"))
    traffic = load_json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    lpath = os.path.join(here, "limits", workload + ".json")
    limits = load_json(lpath)["numbers"] if os.path.exists(lpath) else {}
    return Cell(workload, int(w["chips"]), cfg, traffic,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)],
                limits)


def reader(name: str, here: str = HERE):
    """The `read(ctx)` function of metric `name`, from
    benchmark/metrics/<name>.py (a name may hold dots, so the file is
    loaded by path)."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, ctx: dict, here: str = HERE) -> dict:
    """{name: {"value", "unit"}} of every entry whose reader finds
    something to read; a reader that returns None leaves its metric out."""
    out = {}
    for m in entries:
        v = reader(m["name"], here)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
