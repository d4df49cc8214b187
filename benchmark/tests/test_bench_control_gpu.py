"""On a card: at a small size, the sound program passes the cells'
limits, and the control (the reference in the program's place at float32
with TF32 on) and each planted fault fail at least one of them. Run on
the chip: python -m pytest benchmark/tests -m gpu"""
import time

import pytest
import torch

from benchmark import check, session, spec
from benchmark.tests.tiny import tiny_bench, tiny_here


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workload,config", [
    ("smpl24.train.e4096", "smpl24_implicit"),
    ("smplh52.train.e2048", "smplh52_implicit")])
def test_control_and_faults_fail(card, tmp_path, workload, config):
    import json
    import os

    here = tiny_here(tmp_path, config=config, pcg_iters=None)
    with open(os.path.join(here, "traffic", "tiny.json"), "w") as f:
        json.dump({"kind": "train", "ranks": 1, "envs_per_rank": 256,
                   "horizon": 8, "mini_batch_size": 512,
                   "num_optim_epoch": 1}, f)
    cell = spec.cell("tiny", tiny_bench(config), here)
    limits = spec.cell(workload).limits
    r = session.run_rank(None, cell, 2**32 + 3, 0.5, False, time.time(),
                         "cuda", controls=True)
    assert check.verdict(r["numbers"], limits)[0], r["numbers"]
    assert not check.verdict(r["control"], limits)[0], r["control"]
    for fault, nums in r["faults"].items():
        assert not check.verdict(nums, limits)[0], (fault, nums)
