"""Every cell, configuration, traffic mix and metric of BENCHMARK.json
loads by name, and a new one takes new files only."""
import json
import os

from benchmark import check, spec
from benchmark.tests.tiny import tiny_bench, tiny_here


def test_every_cell_loads_by_name():
    bench = spec.benchmark_file()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert spec.load_json(os.path.join(spec.ROOT, c["file"]))["name"] \
            == c["name"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert w["config"] in names
        assert cell.traffic["ranks"] == cell.chips
        assert set(check.NUMBERS) <= set(cell.limits), w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))


def test_new_files_need_no_edit(tmp_path):
    here = tiny_here(tmp_path)
    with open(os.path.join(here, "configs", "tiny_h.json"), "w") as f:
        json.dump(spec.load_json(os.path.join(
            here, "configs", "smplh52_implicit.json")), f)
    with open(os.path.join(here, "traffic", "burst.json"), "w") as f:
        json.dump({"kind": "train", "ranks": 1, "envs_per_rank": 2,
                   "horizon": 2}, f)
    with open(os.path.join(here, "metrics", "answer.py"), "w") as f:
        f.write("def read(ctx):\n    return 42\n")
    with open(os.path.join(here, "metrics", "silent.py"), "w") as f:
        f.write("def read(ctx):\n    return None\n")
    bench = tiny_bench()
    bench["workloads"].append({"name": "new.cell", "config": "tiny_h",
                               "traffic": "burst", "chips": 1, "why": "t"})
    bench["per_layer"] += [
        {"name": "answer", "unit": "n", "better": "higher",
         "source": "program_counter", "layer": "x", "moves": "setup_s",
         "workloads": ["new.cell"]},
        {"name": "silent", "unit": "n", "better": "higher",
         "source": "program_counter", "layer": "x", "moves": "setup_s"}]
    cell = spec.cell("new.cell", bench, here)
    assert cell.config["bodies"] == 52
    assert cell.traffic["envs_per_rank"] == 2
    names = [m["name"] for m in cell.per_layer]
    assert "answer" in names and "silent" in names
    got = spec.read_metrics([m for m in cell.per_layer
                             if m["name"] in ("answer", "silent")], {}, here)
    assert got == {"answer": {"value": 42.0, "unit": "n"}}
    # a metric scoped to other cells stays out of this one
    other = spec.cell("tiny", bench, here)
    assert "answer" not in [m["name"] for m in other.per_layer]
