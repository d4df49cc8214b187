"""The comparison that decides `correct`: what the timed path produced,
layer by layer, against the plain reference (benchmark/reference/) in
float64, each number beside its limit (benchmark/limits/<workload>.json).

The reference follows the program step by step from the program's own
state: a layer takes the inputs that the program's layer took (the
captured step's state and action, the rollout's rewards and values, the
update's parameters, batch and shuffle), so that a chaotic rollout does
not carry one rounding into the next layer. What it starts from is
checked by itself: the initial weights, drawn again from the seed; the
model, contact points and expert library the reference builds for
itself from the configuration and the motion file.

Numbers (each the worst over its rows; `limits` gives each its limit):
- init_gap: largest |Δ| of the initial policy and value weights (0);
- physics_p90: the captured control step (K1 / K1d) against the float64
  plain chain at the configured PCG schedule, per env the larger of
  max|Δqpos| / 1e-5 and max|Δqvel| / 1e-3, 90th percentile over the envs
  (an env on a contact switch that rounding crosses reads far off; one in
  ten may);
- physics_far: the share of those envs whose gap, by the same measure,
  is over FAR or not finite (what physics_p90 leaves to its tail: a block
  of envs the kernel got wrong, say);
- env_gap: the env step's obs, reward and reward terms after that
  physics, max |Δ| / (1 + |ref|);
- done_miss: envs whose done differs, leaving out an env whose body
  distance lies within 1e-4 of the threshold (0);
- nets_gap: the policy mean at that step and the value of those rows,
  max |Δ| over the largest |ref|;
- gae_gap: the epoch's whitened advantages (max |Δ|) and returns (max
  |Δ| over the largest |ref|), over every rank's envs;
- ppo_loss_gap: the first three PPO steps' value loss (over |ref|) and
  policy loss (over the minibatch's mean |advantage|), computed from the
  program's own outputs at each step;
- ppo_grad_gap: the first step's gradient as each Adam got it (exp_avg /
  (1 - β1)), the worst leaf's |‖g‖ - ‖g_ref‖| over the larger of its
  ‖g_ref‖ and the median leaf's; under data parallelism the all-reduced
  gradient of the global minibatch;
- ppo_change_gap: the parameters' change after three steps, by the same
  measure; leaves whose reference gradient is under a thousandth of the
  median leaf's are left out (round-off alone moves them under Adam).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.probes import PPO_STEPS
from benchmark.reference import learn as RL
from benchmark.reference import nets as RN
from benchmark.reference.frozen.envs import humanoid_im as RH
from benchmark.reference.frozen.physics import solver as RS

QPOS_TOL, QVEL_TOL = 1e-5, 1e-3
# an env's physics gap (in tolerances) counted as far off by physics_far
FAR = 100.0
# the gaps at which the control readings (benchmark/control.py) count the
# far-off share, for setting FAR and physics_far's limit
TAIL_AT = (1.0, 10.0, 100.0, 1000.0, 10000.0)
# the envs the "last_envs" fault leaves unchanged
LAST_ENVS = 256
NUMBERS = ("init_gap", "physics_p90", "physics_far", "env_gap", "done_miss", "nets_gap",
           "gae_gap", "ppo_loss_gap", "ppo_grad_gap", "ppo_change_gap")


class Comm:
    """The benchmark's own collectives across ranks (torch.distributed
    directly, none of the program's), or nothing for one process."""

    def __init__(self, world: int = 1, rank: int = 0):
        self.world, self.rank = world, rank

    def sum(self, x):
        if self.world > 1:
            import torch.distributed as D

            D.all_reduce(x)
        return x

    def cat(self, x, dim: int = 0):
        """Every rank's `x` (one shape on all) joined along `dim` in rank
        order."""
        if self.world == 1:
            return x
        buf = x.new_zeros((self.world,) + tuple(x.shape))
        buf[self.rank] = x
        self.sum(buf)
        return torch.cat(list(buf.unbind(0)), dim)


def _f(x, dtype):
    return x.to(dtype) if torch.is_tensor(x) and torch.is_floating_point(x) \
        else x


def ref_state(state, dtype):
    """The program's EnvState as the frozen module's, floats in `dtype`."""
    return RH.EnvState(**{f.name: _f(getattr(state, f.name), dtype)
                          for f in dataclasses.fields(RH.EnvState)})


# -- inputs and the program's outputs, gathered --------------------------------
def gather(cap: dict, comm: Comm, envs: int, horizon: int, minibatch: int,
           num_optim_epoch: int) -> dict:
    """The global pieces the GAE and PPO numbers need, on every rank."""
    g = cap["gae"]
    gae = {k: comm.cat(g[k], 1 if g[k].dim() == 2 else 0)
           for k in ("rewards", "masks", "values", "bootstrap", "advantages",
                     "returns")}
    gae["gamma"], gae["tau"] = g["gamma"], g["tau"]
    p = cap["ppo"]
    Bg = envs * comm.world
    N = horizon * Bg
    gen = torch.Generator(device=p["gen_device"])
    gen.set_state(p["gen_state"])
    idxs = []
    for _ in range(num_optim_epoch):
        perm = torch.randperm(N, generator=gen, device=gen.device)
        n_mb = max(N // minibatch, 1)
        mb = minibatch if N >= minibatch else N
        idxs += [perm[i * mb:(i + 1) * mb] for i in range(n_mb)]
        if len(idxs) >= PPO_STEPS:
            break
    idxs = idxs[:PPO_STEPS]
    b = p["batch"]
    dev = b["states"].device
    cols = {"states": b["states"], "actions": b["actions"],
            "advantages": b["advantages"][:, None],
            "returns": b["returns"][:, None], "exps": b["exps"][:, None],
            "mean0": p["outputs"]["policy"][0]}
    mbs = []
    for k, idx in enumerate(idxs):
        idx = idx.to(dev)
        t, col = idx // Bg, idx % Bg
        own = (col // envs) == comm.rank
        local = (t * envs + col - comm.rank * envs)[own]
        row = {}
        for name, src in list(cols.items()) + [
                ("mean_k", p["outputs"]["policy"][k + 1]),
                ("value_k", p["outputs"]["value"][k + 1][:, None])]:
            buf = src.new_zeros((len(idx), src.shape[1]))
            if name not in ("mean_k", "value_k"):
                buf[own] = src[local]
            elif src.shape[0] == int(own.sum()):
                buf[own] = src
            else:
                # the program's step took other rows than its shuffle gives
                buf[own] = float("nan")
            row[name] = comm.sum(buf)
        for name in ("advantages", "returns", "exps", "value_k"):
            row[name] = row[name][:, 0]
        row["rank_of"] = col // envs
        mbs.append(row)
    return {"gae": gae, "minibatches": mbs}


def program_outputs(cap: dict, glob: dict, init: dict) -> dict:
    """What the program produced, in the reference's terms (float64)."""
    d = torch.float64
    env = cap["env"]["out"]
    p = cap["ppo"]
    log_std = p["log_std"].to(d)
    losses = []
    for mb in glob["minibatches"]:
        flp = RN.log_prob(mb["mean0"].to(d), log_std, mb["actions"].to(d))
        lp = RN.log_prob(mb["mean_k"].to(d), log_std, mb["actions"].to(d))
        losses.append((((mb["value_k"].to(d) - mb["returns"].to(d)) ** 2)
                       .mean(), _surrogate(lp, flp, mb, cap["clip"])))
    return {
        "init": init,
        "physics": (env[0].qpos, env[0].qvel),
        "env": {"obs": env[1], "reward": env[2], "terms": env[3],
                "done": env[4]},
        "mean": cap["policy"]["mean"], "value": cap["value"]["value"],
        "gae": (glob["gae"]["advantages"], glob["gae"]["returns"]),
        "ppo": {"losses": losses,
                "grads": {**{"value." + k: v
                             for k, v in p["grads_value"].items()},
                          **{"policy." + k: v
                             for k, v in p["grads_policy"].items()}},
                "params": {**{"value." + k: v
                              for k, v in p["params_value"].items()},
                           **{"policy." + k: v
                              for k, v in p["params_policy"].items()}}}}


def _surrogate(lp, flp, mb, clip):
    d = lp.dtype
    adv, exps = mb["advantages"].to(d), mb["exps"].to(d)
    ratio = torch.exp(lp - flp)
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    return -(surr * exps).sum() / torch.clamp(exps.sum(), min=1.0)


# -- the reference in the program's place ---------------------------------------
def reference_outputs(world, cap: dict, glob: dict, seed: int, comm: Comm,
                      fault: str | None = None, trace=None) -> dict:
    """The reference's outputs from the program's inputs, in world.dtype
    (float64 for the check; float32 with TF32 for the control). `fault`
    plants one of the faults the control readings hold the numbers
    against: "unchanged" (the control step and the optimizer return
    their state unchanged), "last_envs" (the control step returns the
    last LAST_ENVS envs' state unchanged), "half_batch" (each minibatch's mean over its
    first half), "no_exchange" (rank 0's rows alone, without the other
    ranks' gradients), "altered" (one env's reward 1 % off, one
    advantage off by 0.01)."""
    d, cfg = world.dtype, world.cfg
    e = cap["env"]
    st = ref_state(e["state"], d)
    act = e["action"].to(d)
    tgt = RH.expert_at(world.lib, st.seq_idx, st.start_ind + st.cur_t + 1)
    if fault == "unchanged":
        qpos, qvel = st.qpos, st.qvel
    else:
        qpos, qvel = RS.do_simulation(world.topo, cfg.env, world.model,
                                      st.qpos, st.qvel, act,
                                      tgt["qpos"][:, 7:], e["rfc_rate"],
                                      world.pcg_iters, trace=trace)
        if fault == "last_envs":
            qpos, qvel = qpos.clone(), qvel.clone()
            qpos[-LAST_ENVS:] = st.qpos[-LAST_ENVS:]
            qvel[-LAST_ENVS:] = st.qvel[-LAST_ENVS:]
    # the env step's post-physics layer from the program's physics output
    prog = e["out"][0]
    post = dataclasses.replace(
        st, qpos=_f(prog.qpos, d), qvel=_f(prog.qvel, d), prev_qpos=st.qpos,
        cur_t=st.cur_t + 1, prev_bquat=RH.get_body_quat(st.qpos),
        obj_qpos=tgt.get("obj_pose", st.obj_qpos))
    s2, obs, reward, terms, done = RH.env_post_step(
        world.topo, world.model, cfg.env, post, act, world.lib,
        world.aux["jpos_diffw"], world.aux["body_diffw"], True)
    if fault == "altered":
        reward = reward.clone()
        reward[0] = reward[0] * 1.01
    margin = None
    if cfg.env.env_term_body == "body":
        margin = (RH.calc_body_diff(world.topo, world.model, post, world.lib,
                                    world.aux["jpos_diffw"])
                  - cfg.env.body_diff_thresh).abs()
    pol_at, val_at = cap["params_at_rollout"]
    pol_at = {k: v.to(d) for k, v in pol_at.items()}
    val_at = {k: v.to(d) for k, v in val_at.items()}
    mean = RN.mcp_mean(pol_at, cap["policy"]["obs"].to(d), cfg.policy_htype)
    value = RN.value(val_at, cap["value"]["obs"].to(d), cfg.value_htype)
    g = glob["gae"]
    adv, ret = RL.gae(g["rewards"].to(d), g["masks"].to(d),
                      g["values"].to(d), g["bootstrap"].to(d), g["gamma"],
                      g["tau"])
    if fault == "altered":
        adv = adv.clone()
        adv[0, 0] += 0.01
    pol_init, val_init = RN.init_params(cfg, cap["obs_dim"],
                                        cap["action_dim"], seed)
    init = {**{"policy." + k: v for k, v in pol_init.items()},
            **{"value." + k: v for k, v in val_init.items()}}
    return {"init": init, "physics": (qpos, qvel),
            "env": {"obs": obs, "reward": reward, "terms": terms,
                    "done": done, "margin": margin},
            "mean": mean, "value": value, "gae": (adv, ret),
            "ppo": reference_ppo(world, cap, glob, comm, fault)}


def reference_ppo(world, cap, glob, comm, fault=None) -> dict:
    d, p = world.dtype, cap["ppo"]
    mbs = [{k: v.to(d) for k, v in mb.items()
            if k in ("states", "actions", "advantages", "returns", "exps")}
           for mb in glob["minibatches"]]
    masks = None
    if fault in ("half_batch", "no_exchange"):
        masks = []
        for mb, raw in zip(mbs, glob["minibatches"]):
            n = mb["exps"].shape[0]
            if fault == "half_batch":
                m = (torch.arange(n, device=mb["exps"].device)
                     < n // 2).to(d)
                masks.append((m, m.sum(), torch.clamp(
                    (mb["exps"] * m).sum(), min=1.0)))
            else:
                m = (raw["rank_of"] == 0).to(d)
                masks.append((m, float(n), torch.clamp(mb["exps"].sum(),
                                                       min=1.0)))
    out = RL.ppo_steps({k: v.to(d) for k, v in p["policy0"].items()},
                       {k: v.to(d) for k, v in p["value0"].items()},
                       p["log_std"].to(d), mbs, world.cfg, masks)
    if fault == "unchanged":
        out["grads"] = {k: torch.zeros_like(v)
                        for k, v in out["grads"].items()}
        out["params"] = {**{"value." + k: v.to(d)
                            for k, v in p["value0"].items()},
                         **{"policy." + k: v.to(d)
                            for k, v in p["policy0"].items()}}
    return out


# -- the numbers ----------------------------------------------------------------
def _worst(*xs) -> float:
    """The largest of `xs`, a NaN counted as infinite (Python's max never
    picks a NaN)."""
    return max(float("inf") if np.isnan(x) else float(x) for x in xs)


def _nanmax(x) -> float:
    x = x.double()
    if x.numel() == 0:
        return 0.0
    return float(torch.where(torch.isnan(x), torch.inf, x).max())


def _rel(a, b):
    d = torch.float64
    return _nanmax((a.to(d) - b.to(d)).abs() / (1.0 + b.to(d).abs()))


def _leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |‖p‖ - ‖r‖| over max(‖r‖, the median leaf's ‖r‖),
    per net."""
    worst = 0.0
    for net in ("policy.", "value."):
        keys = [k for k in ref if k.startswith(net)
                and (keep is None or k in keep)]
        if not keys:
            continue
        rn = {k: float(torch.linalg.vector_norm(ref[k].double()))
              for k in keys}
        med = float(np.median(list(rn.values())))
        for k in keys:
            pn = float(torch.linalg.vector_norm(prog[k].double()))
            gap = abs(pn - rn[k]) / max(rn[k], med, 1e-300)
            worst = max(worst, gap if np.isfinite(gap) else np.inf)
    return worst


def physics_gaps(prog: dict, ref: dict):
    """Per env of the captured control step, the larger of max|Δqpos| /
    QPOS_TOL and max|Δqvel| / QVEL_TOL (a NaN infinite), over the envs
    whose reference state is sound (finite, |qvel| <= 1e4)."""
    d = torch.float64
    q, v = (x.to(d) for x in prog["physics"])
    rq, rv = (x.to(d) for x in ref["physics"])
    sound = torch.isfinite(rq).all(1) & torch.isfinite(rv).all(1) & \
        (rv.abs().amax(1) <= 1e4)
    per_env = torch.maximum((q - rq).abs().amax(1) / QPOS_TOL,
                            (v - rv).abs().amax(1) / QVEL_TOL)
    return torch.where(torch.isnan(per_env), torch.inf, per_env)[sound]


def far_share(per_env, at: float) -> float:
    """The share of `per_env` over `at` (an infinite gap included)."""
    if not per_env.numel():
        return 0.0
    return float((per_env > at).sum()) / per_env.numel()


def numbers(prog: dict, ref: dict, ppo0: dict, glob: dict,
            thresh: float, tails: bool = False) -> dict:
    """Each compared number of `prog` (the program's outputs, or the
    control's) against `ref` (the float64 reference's); with `tails`, also
    physics_far's share at each gap of TAIL_AT (`physics_over_<gap>`)."""
    d = torch.float64
    init = _worst(*(_nanmax((prog["init"][k].double().cpu()
                        - ref["init"][k].double().cpu()).abs())
               for k in ref["init"]))
    per_env = physics_gaps(prog, ref)
    p90 = float(torch.quantile(per_env, 0.9)) if per_env.numel() else 0.0
    pe, re_ = prog["env"], ref["env"]
    env_gap = _worst(*(_rel(pe[k], re_[k]) for k in ("obs", "reward",
                                                       "terms")))
    miss = pe["done"].cpu() != re_["done"].cpu()
    if re_["margin"] is not None:
        miss &= re_["margin"].cpu() > 1e-4 * thresh
    nets_gap = _worst(
        _nanmax((prog["mean"].to(d) - ref["mean"].to(d)).abs())
        / max(float(ref["mean"].abs().max()), 1e-30),
        _nanmax((prog["value"].to(d) - ref["value"].to(d)).abs())
        / max(float(ref["value"].abs().max()), 1e-30))
    pa, pr = prog["gae"]
    ra, rr = ref["gae"]
    gae_gap = _worst(_nanmax((pa.to(d) - ra.to(d)).abs()),
                     _nanmax((pr.to(d) - rr.to(d)).abs())
                     / max(float(rr.abs().max()), 1e-30))
    loss_gap = 0.0
    for (pv, pp), (rv_, rp), mb in zip(prog["ppo"]["losses"],
                                       ref["ppo"]["losses"],
                                       glob["minibatches"]):
        exps = mb["exps"].to(d)
        scale = float((mb["advantages"].to(d).abs() * exps).sum()
                      / torch.clamp(exps.sum(), min=1.0))
        loss_gap = _worst(loss_gap,
                          abs(float(pv) - float(rv_)) / max(abs(float(rv_)),
                                                            1e-30),
                          abs(float(pp) - float(rp)) / max(scale, 1e-30))
    rg = ref["ppo"]["grads"]
    grad_gap = _leaf_gap(prog["ppo"]["grads"], rg)
    keep = set()
    for net in ("policy.", "value."):
        ks = [k for k in rg if k.startswith(net)]
        norms = {k: float(torch.linalg.vector_norm(rg[k].double()))
                 for k in ks}
        med = float(np.median(list(norms.values())))
        keep |= {k for k in ks if norms[k] >= 1e-3 * med}
    change_gap = _leaf_gap(
        {k: prog["ppo"]["params"][k].to(d) - ppo0[k].to(d) for k in rg},
        {k: ref["ppo"]["params"][k].to(d) - ppo0[k].to(d) for k in rg}, keep)
    out = {"init_gap": init, "physics_p90": p90,
           "physics_far": far_share(per_env, FAR), "env_gap": env_gap,
           "done_miss": float(miss.sum()), "nets_gap": nets_gap,
           "gae_gap": gae_gap, "ppo_loss_gap": loss_gap,
           "ppo_grad_gap": grad_gap, "ppo_change_gap": change_gap}
    if tails:
        out.update({f"physics_over_{at:g}": far_share(per_env, at)
                    for at in TAIL_AT})
    return out


def merge(rows: list) -> dict:
    """Every rank's numbers as one: the worst of each (a NaN infinite)."""
    return {k: _worst(*(r[k] for r in rows)) for k in rows[0]}


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, [[name, number, limit], ...]): each number at most its
    limit; a number without a limit, or not finite, fails."""
    rows, ok = [], True
    for name in NUMBERS:
        v = nums.get(name)
        lim = limits.get(name, {}).get("limit")
        good = v is not None and lim is not None and np.isfinite(v) \
            and v <= lim
        ok &= bool(good)
        rows.append([name, v, lim])
    return ok, rows
