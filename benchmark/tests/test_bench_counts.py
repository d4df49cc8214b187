"""The frozen counts equal the port's: control_step_flops on the same
contact sets (both trees), and the bytes from the port's packed tables."""
import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.counts import control_step as FC
from benchmark.counts import nets as NF
from benchmark.reference import world as W
from benchmark.reference.frozen.physics import solver as RS
from benchmark.reference.frozen.physics.model import model_to_numpy
from uhc_tpu_torch.learn import nets
from uhc_tpu_torch.physics import control_step as CS


@pytest.mark.parametrize("name", ["smpl24_implicit", "smplh52_implicit"])
def test_frozen_count_equals_the_ports(name):
    c = spec.load_json(f"{spec.HERE}/configs/{name}.json")
    w = W.build(c, "cpu", torch.float32)
    lib = w.lib
    B = 8
    g = torch.Generator().manual_seed(0)
    si = torch.randint(0, lib["qpos"].shape[0], (B,), generator=g)
    ti = torch.randint(0, int(lib["len"].min()) - 1, (B,), generator=g)
    qpos, tb = lib["qpos"][si, ti], lib["qpos"][si, ti + 1, 7:]
    qvel = 0.05 * torch.randn((B, w.topo.nv), generator=g)
    act = 0.02 * torch.randn((B, c["action_dim"]), generator=g)
    trace = []
    RS.do_simulation(w.topo, w.cfg.env, w.model, qpos, qvel, act, tb, 1.0,
                     tuple(c["pcg_iters"]), trace=trace)
    trace = [np.asarray(a) for a in trace]
    assert any(a.any() for a in trace)
    pcg = tuple(c["pcg_iters"])
    assert FC.control_step_flops(w.topo, w.cfg.env, trace, pcg) == \
        CS.control_step_flops(w.topo, w.cfg.env, trace, pcg)
    params, itab = CS.pack_tables(w.topo, w.cfg.env,
                                  model_to_numpy(w.model), pcg)
    assert FC.control_step_bytes(w.topo, w.cfg.env, w.model, B, pcg) == \
        4 * (qpos.numel() * 2 + qvel.numel() * 2 + act.numel() + tb.numel()
             + params.size + itab.size)


def test_net_flops():
    cfg = W.config_of(spec.load_json(
        f"{spec.HERE}/configs/smpl24_implicit.json"))
    f = NF.mcp_flops(784, 75, cfg.policy_hsize, cfg.composer_dim,
                     cfg.num_primitive)
    pol = nets.policy_mcp_init(784, 75, cfg.policy_hsize, cfg.composer_dim,
                               cfg.num_primitive, torch.Generator(), "relu",
                               "cpu")
    weights = sum(p.numel() for k, p in pol.named_parameters()
                  if "ws" in k or "head_w" in k)
    # two operations a weight, and the mix's two a primitive and action
    assert f == 2.0 * weights + 2.0 * 8 * 75
