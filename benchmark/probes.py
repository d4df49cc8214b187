"""What the benchmark reads off the timed path, through public PyTorch hooks
and the module attributes the program looks up when it calls them; the
program's files are not touched.

- the env step: `envs.humanoid_im.make_env_step_batched` is wrapped before
  the agent builds its rollout, so each step's input state, action and
  output (state, obs, reward, terms, done) pass by; the step counts the
  env steps whose state came back blown up (non-finite, or |qvel| > 1e4,
  the port's rule), on the device;
- the rollout: the agent's `_rollout` is wrapped, which tells an epoch's
  rollout from its update;
- the policy: a forward pre-hook records a CUDA event at every rollout
  step's policy call (the step-time tail), a forward hook keeps the
  captured step's observations and mean action, and the update's first
  minibatches' outputs;
- the value net: a forward hook keeps the captured step's rows of the
  rollout's values, and the update's first minibatches' outputs;
- GAE and PPO: `learn.agent.estimate_advantages` and `ppo_update` /
  `ppo_update_dist` are wrapped (inputs and outputs; the parameters and
  the shuffle generator's state before the update);
- Adam: step post-hooks keep the first step's `exp_avg` (the first
  gradient, as the optimizer got it) and the parameters after step 3.

Nothing is copied while nothing is armed, and a capture keeps
references to tensors the program does not write again."""
from __future__ import annotations

import contextlib

import torch

PPO_STEPS = 3


class Probe:
    def __init__(self, capture_step: int):
        self.capture_step = capture_step
        # set by the caller: which epoch's rollout layers and which
        # epoch's update to capture; whether to record step events
        self.env_epoch = None
        self.ppo_epoch = None
        self.record_steps = False
        self.count_steps = False
        self.spans = False          # a profiler span around each rollout
        self.epoch = -1
        self.step = -1
        self.in_rollout = False
        self.in_ppo = False
        self.events = []            # per epoch: the rollout's step events
        self.env_steps = 0
        self.blown = None
        self.cap = {}

    # -- patches the program looks up at call time ---------------------------
    @contextlib.contextmanager
    def installed(self):
        from uhc_tpu_torch.envs import humanoid_im as H
        from uhc_tpu_torch.learn import agent as A

        saved = {(H, "make_env_step_batched"): H.make_env_step_batched,
                 (A, "estimate_advantages"): A.estimate_advantages,
                 (A, "ppo_update"): A.ppo_update,
                 (A, "ppo_update_dist"): A.ppo_update_dist}
        H.make_env_step_batched = self._wrap_make(H.make_env_step_batched)
        A.estimate_advantages = self._wrap_gae(A.estimate_advantages)
        A.ppo_update = self._wrap_ppo(A.ppo_update, gen_at=6)
        A.ppo_update_dist = self._wrap_ppo(A.ppo_update_dist, gen_at=6)
        try:
            yield self
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)

    def _wrap_make(self, make):
        probe = self

        def make_env_step_batched(topo, cfg, fused_model=None):
            step = make(topo, cfg, fused_model=fused_model)

            def wrapped(model, states, actions, expert_lib, jpos_diffw,
                        body_diffw, rfc_rate=1.0, train=True):
                out = step(model, states, actions, expert_lib, jpos_diffw,
                           body_diffw, rfc_rate, train)
                probe._env_step(states, actions, rfc_rate, out)
                return out

            wrapped.kernel = step.kernel
            return wrapped

        return make_env_step_batched

    def _env_step(self, states, actions, rfc_rate, out):
        if self.count_steps:
            s = out[0]
            blown = (~torch.isfinite(s.qpos).all(1)
                     | ~torch.isfinite(s.qvel).all(1)
                     | (s.qvel.abs().amax(1) > 1e4)).sum()
            self.blown = blown if self.blown is None else self.blown + blown
            self.env_steps += s.qpos.shape[0]
        if self._capturing_env():
            self.cap["env"] = {"state": states, "action": actions,
                               "rfc_rate": float(rfc_rate), "out": out}

    def _capturing_env(self):
        return (self.in_rollout and self.epoch == self.env_epoch
                and self.step == self.capture_step)

    def _wrap_gae(self, fn):
        probe = self

        def estimate_advantages(rewards, masks, values, bootstrap, gamma,
                                tau, dist=None):
            adv, ret = fn(rewards, masks, values, bootstrap, gamma, tau,
                          dist=dist)
            if probe.epoch == probe.env_epoch:
                probe.cap["gae"] = {"rewards": rewards, "masks": masks,
                                    "values": values, "bootstrap": bootstrap,
                                    "gamma": gamma, "tau": tau,
                                    "advantages": adv, "returns": ret}
            return adv, ret

        return estimate_advantages

    def _wrap_ppo(self, fn, gen_at: int):
        probe = self

        def ppo(*args, **kw):
            if probe.epoch != probe.ppo_epoch:
                return fn(*args, **kw)
            policy, value, _, _, log_std, batch, gen = args[:gen_at + 1]
            probe.cap["ppo"] = {
                "policy0": {k: p.detach().clone()
                            for k, p in policy.named_parameters()},
                "value0": {k: p.detach().clone()
                           for k, p in value.named_parameters()},
                "log_std": log_std.detach().clone(), "batch": batch,
                "gen_state": gen.get_state(), "gen_device": gen.device,
                "outputs": {"policy": [], "value": []}}
            probe.in_ppo = True
            try:
                return fn(*args, **kw)
            finally:
                probe.in_ppo = False

        return ppo

    # -- hooks on the agent's objects ----------------------------------------
    def attach(self, agent):
        rollout = agent._rollout

        def wrapped(*a, **k):
            self.epoch += 1
            self.step = -1
            self.in_rollout = True
            if self.record_steps:
                self.events.append([])
            span = (torch.profiler.record_function("bench.rollout")
                    if self.spans else contextlib.nullcontext())
            try:
                with span:
                    return rollout(*a, **k)
            finally:
                self.in_rollout = False

        agent._rollout = wrapped
        agent.policy.register_forward_pre_hook(self._policy_pre)
        agent.policy.register_forward_hook(self._policy_out)
        agent.value.register_forward_hook(self._value_out)
        agent.value_opt.register_step_post_hook(self._opt_hook("value"))
        agent.policy_opt.register_step_post_hook(self._opt_hook("policy"))
        self.agent = agent

    def _policy_pre(self, module, args):
        if not self.in_rollout:
            return
        self.step += 1
        if self.record_steps:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[-1].append(e)

    def _policy_out(self, module, args, out):
        if self.in_rollout and self.epoch == self.env_epoch \
                and self.step == self.capture_step:
            self.cap["policy"] = {"obs": args[0], "mean": out}
        elif self.in_ppo:
            self._ppo_output("policy", out)

    def _value_out(self, module, args, out):
        if self.in_ppo:
            self._ppo_output("value", out)
        elif (not self.in_rollout and self.epoch == self.env_epoch
              and "value" not in self.cap):
            # the first value call after the rollout: V of every row
            B = self.cap["policy"]["obs"].shape[0]
            rows = slice(self.capture_step * B, (self.capture_step + 1) * B)
            self.cap["value"] = {"obs": args[0][rows].clone(),
                                 "value": out[rows].clone()}

    def _ppo_output(self, net, out):
        outs = self.cap["ppo"]["outputs"][net]
        if len(outs) <= PPO_STEPS:
            # call 0: the whole batch (log-probs / value loss before);
            # calls 1..3: the first minibatches' rows
            outs.append(out.detach().clone())

    def _opt_hook(self, net):
        def hook(opt, args, kwargs):
            if not self.in_ppo:
                return
            c = self.cap["ppo"]
            key = net + "_steps"
            c[key] = c.get(key, 0) + 1
            names = dict((id(p), k) for k, p in (
                self.agent.policy if net == "policy"
                else self.agent.value).named_parameters())
            if c[key] == 1:
                # an optimizer that made no step holds no moment: zero
                c["grads_" + net] = {
                    names[id(p)]: (opt.state[p]["exp_avg"]
                                   / (1 - opt.defaults["betas"][0])).clone()
                    if "exp_avg" in opt.state[p] else torch.zeros_like(p)
                    for g in opt.param_groups for p in g["params"]}
            if c[key] == PPO_STEPS:
                c["params_" + net] = {k: p.detach().clone() for k, p in (
                    self.agent.policy if net == "policy"
                    else self.agent.value).named_parameters()}
        return hook

    # -- after the window -----------------------------------------------------
    def step_ms(self) -> list:
        """Every rollout step's time in the recorded epochs: the ms between
        the CUDA events of consecutive policy calls of one rollout."""
        out = []
        for evs in self.events:
            for e0, e1 in zip(evs[:-1], evs[1:]):
                e1.synchronize()
                out.append(e0.elapsed_time(e1))
        return out
