"""Reading the program's span table (`uhc_tpu_torch/utils/spans.py`) out
of the window's epoch stats: `<path>.s`, `<path>.n`, `<path>.device_s`
and `count.<name>`, each epoch's own. The traced epoch is not among
them, so the profiler's stretch is not in these numbers. Every function
returns None where a rank's stats lack the keys (a program without the
span or counter)."""
from __future__ import annotations


def _rank_stats(ctx, key: str):
    """Each rank's window epochs, or None where one lacks `key`."""
    stats = [r["stats"] for r in ctx["ranks"]]
    if not all(st and all(key in s for s in st) for st in stats):
        return None
    return stats


def per_call_ms(ctx, path: str, key: str = "s"):
    """ms a call of span `path` takes (`key` "s": host, "device_s":
    device): each rank's seconds over its calls, the mean over ranks."""
    stats = _rank_stats(ctx, f"{path}.{key}")
    if stats is None:
        return None
    per = []
    for st in stats:
        calls = sum(s[f"{path}.n"] for s in st)
        if not calls:
            return None
        per.append(1e3 * sum(s[f"{path}.{key}"] for s in st) / calls)
    return sum(per) / len(per)


def per_epoch_ms(ctx, path: str):
    """Host ms of span `path` per epoch, the mean over epochs and ranks."""
    stats = _rank_stats(ctx, f"{path}.s")
    if stats is None:
        return None
    per = [1e3 * sum(s[f"{path}.s"] for s in st) / len(st) for st in stats]
    return sum(per) / len(per)


def per_epoch_counts(stats: list, match):
    """A rank's counters whose name `match` accepts, summed, per epoch;
    None where no epoch has any."""
    keys = {k for s in stats for k in s
            if k.startswith("count.") and match(k[6:])}
    if not stats or not keys:
        return None
    return sum(s.get(k, 0) for s in stats for k in keys) / len(stats)
