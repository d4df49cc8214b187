"""Re-scoring of dumped rollouts (PyTorch-port twin of
uhc_tpu.cli.eval_imitation, the reference's scripts/eval_imitation.py).

Reads a pickle of {key: {pred_qpos, gt_qpos, pred_jpos, gt_jpos,
fail_safe, percent}}, as `python -m uhc_tpu_torch.cli.eval --dump PATH`
(or the JAX eval CLI) writes it, and recomputes succ / mpjpe / pa_mpjpe /
mpjpe_g / root_dist / vel_dist / accel_dist without the simulator, on the
host. Reads joblib files too, without joblib.

Usage:
  python -m uhc_tpu_torch.cli.eval_imitation --results PATH
      [--json OUT.json]
Prints one line of metrics per key and one SUMMARY JSON line.
"""
from __future__ import annotations

import argparse
import json


def score(data: dict) -> dict:
    """{key: trajectories} -> {"per_seq": {key: metrics}, "summary"}: the
    mean of every metric, coverage (the count of successes) and
    num_seqs."""
    import numpy as np

    from uhc_tpu_torch.learn.metrics import compute_metrics

    per_seq, agg = {}, {}
    for key, d in data.items():
        m = compute_metrics(
            np.asarray(d["pred_qpos"]), np.asarray(d["gt_qpos"]),
            np.asarray(d["pred_jpos"]), np.asarray(d["gt_jpos"]),
            bool(d.get("fail_safe", False)), float(d.get("percent", 1.0)))
        per_seq[key] = m
        for k, v in m.items():
            agg.setdefault(k, []).append(v)
    summary = {k: float(np.mean(v)) for k, v in agg.items()}
    summary["coverage"] = int(sum(m["succ"] for m in per_seq.values()))
    summary["num_seqs"] = len(per_seq)
    return {"per_seq": per_seq, "summary": summary}


def main(argv=None) -> dict:
    from uhc_tpu_torch.data import joblib_compat

    p = argparse.ArgumentParser(prog="python -m uhc_tpu_torch.cli."
                                     "eval_imitation")
    p.add_argument("--results", required=True,
                   help="trajectory pickle from cli/eval --dump")
    p.add_argument("--json", default=None, help="write the result here")
    args = p.parse_args(argv)
    res = score(joblib_compat.load(args.results))
    for key, m in res["per_seq"].items():
        print(key, json.dumps({k: round(float(v), 2) for k, v in m.items()}))
    print("SUMMARY", json.dumps(res["summary"]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
