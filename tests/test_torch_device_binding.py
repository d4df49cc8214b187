"""Kernel launches on their tensors' card (no JAX; needs two CUDA cards):
the ctypes entries launch on the thread's current device, so
ControlStep and ControlStepSplit make the tensors' card current around
each launch; a data-parallel rank on cuda:1 may find cuda:0 current. And
two ranks, a card each over NCCL, through a wait longer than the
collectives' timeout. Run on a machine with two cards or more:
`python -m pytest --noconftest -m gpu tests/test_torch_device_binding.py`."""
import numpy as np
import pytest
import torch

GAIT = "sample_data/gait_clips.pkl"


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True], ids=["k1", "k2"])
def test_launch_follows_the_tensors_card(split):
    """K1 (or K2's head and tail) on cuda:1 while cuda:0 is current: one
    launch counted per kernel, and the outputs equal, bit for bit, the
    same step's on cuda:0 from the same inputs."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    topo, model_np = load_fixture_humanoid()
    cfg = Config.uhc_implicit().env
    lib, _ = build_expert_library(topo, model_from_numpy(model_np, "cpu"),
                                  load_motion_file(GAIT), max_len=30)
    rng = np.random.default_rng(3)
    frames = lib["qpos"].numpy()
    si, ti = rng.integers(0, frames.shape[0], 64), rng.integers(0, 28, 64)
    qpos = frames[si, ti]
    qvel = (0.05 * rng.standard_normal((64, 75))).astype(np.float32)
    tb = np.ascontiguousarray(frames[si, ti + 1, 7:])
    act = (0.02 * rng.standard_normal(
        (64, sum(H.action_dims(topo, cfg))))).astype(np.float32)
    outs = {}
    CS.reset_launches()
    for dev in ("cuda:1", "cuda:0"):
        with torch.cuda.device(0):
            model = model_from_numpy(model_np, dev)
            step = (K2.ControlStepSplit(topo, cfg, model, 2) if split
                    else CS.ControlStep(topo, cfg, model, (1, 2)))
            ins = [torch.tensor(np.ascontiguousarray(x), device=dev)
                   for x in (qpos, qvel, act, tb)]
            outs[dev] = [x.cpu() for x in step(*ins, 1.0)]
    entries = ("head", "tail") if split else ("step",)
    assert dict(CS.LAUNCHES) == {(e, 24, False): 2 for e in entries}
    for a, b in zip(outs["cuda:1"], outs["cuda:0"]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_nccl_ranks_outlast_the_collective_timeout():
    """Rank 0 (cuda:0) works 15 s with no collective while rank 1 (cuda:1)
    waits in Dist.barrier, in an NCCL group whose collectives time out
    after 10 s: the barrier holds no collective pending (the NCCL
    watchdog aborts one past the timeout), so both ranks return the
    sum."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import test_torch_dp_ranks as R
    from uhc_tpu_torch.learn import data_parallel as DP

    assert DP.spawn(R.slow_rank0, 2, "cuda", "nccl", args=(15.0,),
                    timeout=10.0, wait=180.0) == [2.0, 2.0]
