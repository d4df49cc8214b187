"""The control and the planted faults of a cell, on the chip at the cell's
own size: for each seed, a run with a short window (set-up, then whole
epochs for `--seconds`), then the compared numbers of the program, of the
control (the reference in the program's place, float32 with TF32 on: the
precision below the configuration's float32 with TF32 off) and of each
fault planted in the reference put in its place (the control step and
Adam returning their state unchanged; the control step returning the
last 256 envs' state unchanged; each minibatch's mean over half of
its rows; one env's reward altered by 1 % and one advantage by 0.01; on
several cards, rank 0's rows without the exchange). Every seed runs in
this one process.

    python -m benchmark.control --workload <cell> --seeds 11 12 13
        [--seconds 1] [--out control_<cell>.jsonl]

One JSON line a seed goes to --out and to standard output; beside the
compared numbers it gives `physics_over_<gap>`, the share of envs whose
physics gap is over each gap of check.TAIL_AT, from which physics_far's
gap (check.FAR) and limit are set. The limits in
benchmark/limits/<cell>.json are set from these readings: above the
largest program reading, below the smallest control or fault reading
that separates from it."""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from benchmark import check, run, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("benchmark.control: not enough CUDA cards", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.time()
            ranks = run.run_cell(cell, seed, args.seconds, False,
                                 controls=True, t_start=t0)
            row = {"workload": cell.name, "seed": seed,
                   "seconds": time.time() - t0}
            for key in ("numbers", "control"):
                row[key] = check.merge([r[key] for r in ranks])
            row["faults"] = {f: check.merge([r["faults"][f] for r in ranks])
                             for f in ranks[0]["faults"]}
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
