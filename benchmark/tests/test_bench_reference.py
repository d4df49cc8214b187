"""The reference agrees with the port at a small size on the CPU: one
control step, the env step's observation, reward and done, the networks,
GAE and one PPO minibatch step."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import learn as RL
from benchmark.reference import nets as RN
from benchmark.reference import world as W
from benchmark.reference.frozen.envs import humanoid_im as RH
from benchmark.reference.frozen.physics import solver as RS
from benchmark import spec
from uhc_tpu_torch.config.config import Config
from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.learn import nets
from uhc_tpu_torch.learn.agent import CopycatAgent
from uhc_tpu_torch.learn.gae import estimate_advantages
from uhc_tpu_torch.learn.ppo import ppo_update
from uhc_tpu_torch.physics import solver as S

CONFIGS = ("smpl24_implicit", "smplh52_implicit")


def _config(name):
    return spec.load_json(f"{spec.HERE}/configs/{name}.json")


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request, tmp_path_factory):
    """The port's agent (6 envs on the CPU, one epoch run) and the
    reference's world of the same configuration, float32 and float64."""
    c = _config(request.param)
    cfg = Config.from_dict(c["cfg_id"], c["config"])
    agent = CopycatAgent(cfg, c["motion_file"], num_envs=6, horizon=3,
                         seed=3, results_dir=str(tmp_path_factory.mktemp("r")),
                         device="cpu")
    agent.optimize_policy(0)
    return (c, agent, W.build(c, "cpu", torch.float32),
            W.build(c, "cpu", torch.float64))


def test_world_matches_the_port(pair):
    c, agent, w32, _ = pair
    assert w32.topo.nbody == c["bodies"] == agent.topo.nbody
    for f in dataclasses.fields(agent.model):
        assert torch.equal(getattr(agent.model, f.name),
                           getattr(w32.model, f.name)), f.name
    for k, v in agent.expert_lib.items():
        assert torch.equal(v, w32.lib[k]), k


def test_control_step(pair):
    c, agent, w32, w64 = pair
    st = agent.env_states
    act = 0.05 * torch.randn((6, agent.action_dim),
                             generator=torch.Generator().manual_seed(1))
    tb = H.expert_at(agent.expert_lib, st.seq_idx,
                     st.start_ind + st.cur_t + 1)["qpos"][:, 7:]
    pcg = tuple(c["pcg_iters"])
    port = S.do_simulation(agent.topo, agent.env_cfg, agent.model, st.qpos,
                           st.qvel, act, tb, 1.0, pcg)
    ref32 = RS.do_simulation(w32.topo, w32.cfg.env, w32.model, st.qpos,
                             st.qvel, act, tb, 1.0, pcg)
    for a, b in zip(port, ref32):
        assert torch.equal(a, b)
    ref64 = RS.do_simulation(w64.topo, w64.cfg.env, w64.model,
                             st.qpos.double(), st.qvel.double(),
                             act.double(), tb.double(), 1.0, pcg)
    per_env = torch.maximum((port[0] - ref64[0]).abs().amax(1) / 1e-5,
                            (port[1] - ref64[1]).abs().amax(1) / 1e-3)
    assert float(per_env.median()) < 1.0


def test_obs_reward_done(pair):
    c, agent, w32, _ = pair
    st = agent.env_states
    act = torch.zeros((6, agent.action_dim))
    step = H.make_env_step_batched(agent.topo, agent.env_cfg)
    s2, obs, rew, terms, done = step(agent.model, st, act, agent.expert_lib,
                                     agent.aux["jpos_diffw"],
                                     agent.aux["body_diffw"])
    rst = RH.EnvState(**{f.name: getattr(st, f.name)
                         for f in dataclasses.fields(RH.EnvState)})
    tgt = RH.expert_at(w32.lib, rst.seq_idx, rst.start_ind + rst.cur_t + 1)
    post = dataclasses.replace(rst, qpos=s2.qpos, qvel=s2.qvel,
                               prev_qpos=rst.qpos, cur_t=rst.cur_t + 1,
                               prev_bquat=RH.get_body_quat(rst.qpos))
    r2, robs, rrew, rterms, rdone = RH.env_post_step(
        w32.topo, w32.model, w32.cfg.env, post, act, w32.lib,
        w32.aux["jpos_diffw"], w32.aux["body_diffw"], True)
    assert torch.equal(obs, robs) and torch.equal(rew, rrew)
    assert torch.equal(terms, rterms) and torch.equal(done, rdone)
    assert obs.shape[1] == c["obs_dim"]


def test_nets_and_gae(pair):
    c, agent, _, w64 = pair
    pol, val = RN.init_params(w64.cfg, c["obs_dim"], c["action_dim"], 3)
    fresh = nets.make_policy(agent.cfg, c["obs_dim"], c["action_dim"],
                             torch.Generator().manual_seed(3), "cpu")
    for k, p in fresh.named_parameters():
        assert torch.equal(p, pol[k]), k
    x = torch.randn(5, c["obs_dim"], generator=torch.Generator()
                    .manual_seed(2))
    got = fresh(x).detach().double()
    want = RN.mcp_mean({k: v.double() for k, v in pol.items()}, x.double())
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())
    g = torch.Generator().manual_seed(4)
    rew, val_, boot = (torch.rand((3, 6), generator=g),
                       torch.rand((3, 6), generator=g),
                       torch.rand(6, generator=g))
    masks = (torch.rand((3, 6), generator=g) > 0.3).float()
    adv, ret = estimate_advantages(rew, masks, val_, boot, 0.95, 0.95)
    radv, rret = RL.gae(rew.double(), masks.double(), val_.double(),
                        boot.double(), 0.95, 0.95)
    assert torch.allclose(adv.double(), radv, atol=1e-5)
    assert torch.allclose(ret.double(), rret, atol=1e-6)


def test_one_ppo_minibatch(pair):
    c, agent, _, w64 = pair
    cfg = agent.cfg
    D, A, N = c["obs_dim"], c["action_dim"], 16
    g = torch.Generator().manual_seed(5)
    batch = {"states": torch.randn((N, D), generator=g),
             "actions": 0.1 * torch.randn((N, A), generator=g),
             "advantages": torch.randn(N, generator=g),
             "returns": torch.randn(N, generator=g),
             "exps": (torch.rand(N, generator=g) > 0.2).float()}
    pol0 = {k: p.detach().clone() for k, p in agent.policy.named_parameters()}
    val0 = {k: p.detach().clone() for k, p in agent.value.named_parameters()}
    popt = torch.optim.Adam(agent.policy.parameters(), lr=cfg.policy_lr)
    vopt = torch.optim.Adam(agent.value.parameters(), lr=cfg.value_lr)
    ppo_update(agent.policy, agent.value, popt, vopt, agent.log_std, batch, torch.Generator().manual_seed(0),
               cfg.clip_epsilon, 1, N)
    ref = RL.ppo_steps({k: v.double() for k, v in pol0.items()},
                       {k: v.double() for k, v in val0.items()},
                       agent.log_std.double(),
                       [{k: v.double() for k, v in batch.items()}], w64.cfg)
    for net, mod in (("policy.", agent.policy), ("value.", agent.value)):
        for k, p in mod.named_parameters():
            r = ref["params"][net + k]
            base = (pol0 if net == "policy." else val0)[k].double()
            dp, dr = p.detach().double() - base, r - base
            scale = max(float(dr.abs().max()), 1e-12)
            # Adam's first step moves each entry by about lr in the sign
            # of its gradient; entries whose gradient is rounding noise
            # may flip
            assert float(np.quantile((dp - dr).abs().flatten().numpy(),
                                     0.99)) <= 1e-3 * scale + 1e-9, net + k
