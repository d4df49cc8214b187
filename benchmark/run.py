"""The benchmark of the PyTorch / CUDA port (`uhc_tpu_torch`): copycat PPO
training, whole epochs of `CopycatAgent.optimize_policy`, on one card or
over several (data parallel, one rank a card over NCCL).

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell of BENCHMARK.json names its configuration and traffic mix
(benchmark/spec.py). A run builds the agent as `cli/train.py` does, runs
one epoch at the cell's shapes (set-up), then whole epochs until
`--seconds` have passed; `--trace 1` profiles one more epoch. Then it
checks what the timed path produced against the plain reference
(benchmark/check.py) and prints, as the last lines of standard error,
each compared number beside its limit, and as the last line of standard
output one JSON object: correct, attempted (the window's env steps),
failed (those whose state came back blown up), the metrics, the device.

It exits non-zero, printing no result, without a card (or with fewer
than the cell asks for) and when JAX or the JAX package `uhc_tpu` was
loaded in the process that prints the result.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# one process, few threads: the host paces the rollout's launches
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool,
             controls: bool = False, t_start: float = T_START) -> list:
    """Every rank's result dict of one run: one process, or the program's
    spawn over `cell.chips` cards, a rank a card over NCCL."""
    from benchmark import session

    if cell.chips == 1:
        return [session.run_rank(None, cell, seed, seconds, trace, t_start,
                                 "cuda", controls)]
    from uhc_tpu_torch.learn import data_parallel

    return data_parallel.spawn(session.rank_entry, cell.chips, "cuda",
                               "nccl", args=(cell, seed, seconds, trace,
                                             t_start, controls),
                               wait=1800.0)


def result(cell, ranks: list, trace: bool, kind: str, count: int) -> dict:
    """The result line's object from every rank's readings."""
    from benchmark import check, spec

    r0 = ranks[0]
    nums = check.merge([r["numbers"] for r in ranks])
    ok, rows = check.verdict(nums, cell.limits)
    ctx = {"ranks": ranks, "cell": cell, "numbers": nums}
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                ctx)
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": max(r.get("memory_peak_bytes", 0)
                                       for r in ranks)}
    out = {"correct": ok,
           "attempted": sum(r["env_steps"] for r in ranks),
           "failed": sum(r["blown"] for r in ranks),
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = sum(r["trace"]["busy_s"] for r in ranks) / len(
            ranks)
        device["window_s"] = sum(r["trace"]["window_s"]
                                 for r in ranks) / len(ranks)
        out["breakdown"] = {"device_ops": r0["trace"]["device_ops"],
                            "idle_gaps": r0["trace"]["idle_gaps"]}
        # the profiler's cost: the traced epoch over the window's mean
        # epoch, mean over ranks
        out["trace_stretch"] = sum(
            r["trace"]["window_s"] * len(r["stats"])
            / sum(s["T_total"] for s in r["stats"]) for r in ranks) / len(
                ranks)
    # each window epoch's seconds (rank 0), for reading a run's spread
    out["epoch_s"] = [s["T_total"] for s in r0["stats"]]
    out["checks"] = rows
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    from benchmark import session, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    ranks = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    out = result(cell, ranks, bool(args.trace), kind, cell.chips)
    out["device"]["power_limit"] = card_line()
    # this process's modules, and each rank's as its last act
    found = sorted(set(session.forbidden_modules()).union(
        *[r["modules"] for r in ranks]))
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for name, v, lim in out["checks"]:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
