"""IMPALA-style V-trace actor-critic on the (data, model) grid (the twin of
apx's ``examples/train_vtrace_mesh.py``).

The off-policy recipe beside PPO's on-policy one:

* a lagged BEHAVIOR copy of the net collects the rollout, synced to the
  learner every ``sync_every`` iterations (the staleness a distributed
  actor fleet would have);
* the learner corrects the off-policy gap with V-trace (rho- and
  c-clipped importance weights, a reverse loop over the rollout) and
  trains the policy (V-trace policy gradient), the value (MSE to the vs
  targets), the entropy and, through the env's differentiable loss term,
  the prediction head, as the PPO recipe does; the prediction gradient is
  added to the learner's and one optimizer step is taken;
* on a grid (``train_ppo_mesh.make_dp_tp_grid``) the env batch is
  data-parallel and the encoder and trunk tensor-parallel, as in
  ``train_ppo_mesh``: the means are over the whole batch and the gradient
  is summed over the data ranks.

    python -m apx_torch.examples.train_vtrace_mesh [num_envs] [iterations]

launches as ``train_ppo_mesh`` does.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import torch

from ..core.env import tree_map
from ..distrib.mesh import local_venv, shard_env_batch
from .train_ppo_lidar import LOG_2PIE, ClipAdam, _grads_to_zero, init_net, logp_gauss, policy_dist
from .train_ppo_mesh import (_sync, launch, rank_args, report, setup_rank, shard_net, trunk_diff,
                             trunk_grad_diff, trunk_worst_grad)

__all__ = ["vtrace", "make_train_iter", "clone_net", "vtrace_check", "main"]


def vtrace(rewards, values, value_last, log_rhos, dones, gamma=0.99, rho_bar=1.0, c_bar=1.0):
    """V-trace targets and policy-gradient advantages (IMPALA eq. 1).

    rewards / values / log_rhos / dones: (T, N); value_last: (N,).
    Returns (vs (T, N), pg_adv (T, N)), detached."""
    with torch.no_grad():
        rho = torch.clamp(torch.exp(log_rhos), max=rho_bar)
        c = torch.clamp(torch.exp(log_rhos), max=c_bar)
        nonterm = 1.0 - dones.to(torch.float32)
        v_next = torch.cat([values[1:], value_last[None]], dim=0)
        deltas = rho * (rewards + gamma * nonterm * v_next - values)
        dv = torch.empty_like(values)
        acc = torch.zeros_like(value_last)
        for t in reversed(range(values.shape[0])):
            acc = deltas[t] + gamma * nonterm[t] * c[t] * acc
            dv[t] = acc
        vs = values + dv
        vs_next = torch.cat([vs[1:], value_last[None]], dim=0)
        pg_adv = rho * (rewards + gamma * nonterm * vs_next - values)
    return vs, pg_adv


def clone_net(net):
    """A copy of ``net`` (a grid shard keeps its grid, which is not copied)."""
    grid, net.grid = net.grid, None
    try:
        twin = copy.deepcopy(net)
    finally:
        net.grid = grid
    twin.grid = grid
    return twin


def make_train_iter(venv, opt: ClipAdam, num_envs, rollout_len=16, gamma=0.99, ent_coef=1e-3,
                    vf_coef=0.5, pred_coef=1.0, sync_every=4, grid=None):
    """One V-trace iteration, apx's ``make_train_iter``: returns
    ``train_iter(net, beh_net, opt_state, env_state, obs, it, generator,
    params, draws=None) -> (env_state, obs, it + 1, mean_reward)``, updating
    ``net``, ``opt_state`` and (every ``sync_every`` iterations) ``beh_net``
    in place. ``draws`` injects what the iteration would take from
    ``generator``: ``noise`` (T, N, 2) the behavior policy's action noise and
    ``reset`` a list of T reset-draw dicts of all N envs, as
    ``train_ppo_lidar.make_train_iter`` takes them. With a ``grid`` it is
    one rank of the dp x tp program (see ``train_ppo_lidar.make_train_iter``)."""
    env = venv.env
    n = rollout_len * num_envs
    local = venv if grid is None else local_venv(venv, grid.env)

    def block(tree):
        return tree if grid is None else shard_env_batch(grid.env, tree)

    def data_sum(x):
        return x if grid is None else grid.data_sum(x)

    def train_iter(net, beh_net, opt_state, env_state, obs, it, generator, params, draws=None):
        dev = params.device
        # ---- collect with the BEHAVIOR policy (the learner's prediction
        # head trains through the differentiable -loss term) --------------
        obs_t, araw_t, r_t, done_t, logp_b_t = [], [], [], [], []
        st = env_state
        for t in range(rollout_len):
            with torch.no_grad():
                mean_b, logstd_b = policy_dist(beh_net, beh_net.encode(obs))
                noise = (draws["noise"][t] if draws is not None
                         else torch.randn((num_envs, 2), generator=generator, device=dev))
                a_raw = mean_b + torch.exp(logstd_b) * block(noise)
            # The prediction comes from the LEARNER net.
            pred = torch.tanh(net.pred(net.encode(obs)))
            step_draws = block(env.draw_step(num_envs, params, generator))
            reset = block(draws["reset"][t] if draws is not None
                          else env.draw_reset(num_envs, params, generator))
            obs2, st, r, te, tr, _ = local.step(
                st, {"action": torch.tanh(a_raw), "prediction": pred}, params,
                reset_draws=reset, step_draws=step_draws)
            obs_t.append(obs)
            araw_t.append(a_raw)
            r_t.append(r)
            done_t.append(te | tr)
            logp_b_t.append(logp_gauss(a_raw, mean_b, logstd_b))
            obs = obs2
        r_t = torch.stack(r_t)
        _grads_to_zero(net)
        (-pred_coef * r_t.sum() / n).backward()  # the prediction gradient
        r_t = r_t.detach()
        obs_t = tree_map(lambda *xs: torch.stack(xs), *obs_t)
        araw_t, done_t, logp_b_t = torch.stack(araw_t), torch.stack(done_t), torch.stack(logp_b_t)
        t_len, n_local = r_t.shape

        # ---- V-trace learner update (its gradient added) ------------------
        flat = tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), obs_t)
        z = net.encode(flat)
        v = net.value(z)[..., 0].reshape(t_len, n_local)
        mean, logstd = policy_dist(net, z.reshape(t_len, n_local, -1))
        logp = logp_gauss(araw_t, mean, logstd)
        with torch.no_grad():
            v_last = net.value(net.encode(obs))[..., 0]
        vs, pg_adv = vtrace(r_t, v.detach(), v_last, logp.detach() - logp_b_t, done_t, gamma)
        pg = -(pg_adv * logp).sum() / n
        vloss = 0.5 * ((v - vs) ** 2).sum() / n
        ent = (logstd + 0.5 * LOG_2PIE).sum(dim=-1).sum() / n
        (pg + vf_coef * vloss - ent_coef * ent).backward()
        if grid is not None:
            grid.reduce_grads(list(net.parameters()))
        opt.step(opt_state, grid)

        # ---- behavior sync every sync_every iterations ------------------
        if (it + 1) % sync_every == 0:
            with torch.no_grad():
                for b, p in zip(beh_net.parameters(), net.parameters()):
                    b.copy_(p)
        return st, obs, it + 1, data_sum(r_t.sum()) / n

    return train_iter


def vtrace_check(grid, num_envs: int, rollout_len: int, iters: int = 2, sync_every: int = 2,
                 seed: int = 5, solo: bool = False) -> dict:
    """``iters`` V-trace iterations on the grid with ``sync_every``: the mean
    rewards (finite), and whether the behavior net equals the learner
    bitwise after them. With ``solo`` also the same iterations in one
    process (this rank, the whole batch, a generator seeded alike): its
    rewards, the largest |difference| of this rank's ``trunk.w`` rows from
    its net's same rows, and of their first iteration's gradients
    (``trunk_grad_diff``)."""
    opt = ClipAdam(0.5, 3e-4)
    venv, params, obs, state, g, net = setup_rank(grid, num_envs, seed)
    shard_net(net, grid)
    beh = clone_net(net)
    opt_state = opt.init(net)
    train_iter = make_train_iter(venv, opt, num_envs, rollout_len, sync_every=sync_every,
                                 grid=grid)
    it, rewards = 0, []
    _sync(grid.device)
    t0 = time.perf_counter()
    for i in range(iters):
        state, obs, it, mean_r = train_iter(net, beh, opt_state, state, obs, it, g, params)
        rewards.append(float(mean_r))
        if i == 0:
            first_grad = net.trunk.weight.grad.clone()
    _sync(grid.device)
    out = {"rewards": rewards, "iters": it, "sync_every": sync_every,
           "behavior_equals_learner": all(torch.equal(a, b) for a, b in
                                          zip(net.parameters(), beh.parameters())),
           "trunk_shape": list(net.trunk.weight.shape),
           "seconds": time.perf_counter() - t0}
    if solo:
        solo_g = torch.Generator(grid.device).manual_seed(seed)
        obs, state, _ = venv.reset(params, solo_g)
        one = init_net(solo_g, params.map_bank.map_hw, grid.device)
        beh, opt_state = clone_net(one), opt.init(one)
        solo_iter = make_train_iter(venv, opt, num_envs, rollout_len, sync_every=sync_every)
        it, out["solo_rewards"] = 0, []
        for i in range(iters):
            state, obs, it, mean_r = solo_iter(one, beh, opt_state, state, obs, it, solo_g, params)
            out["solo_rewards"].append(float(mean_r))
            if i == 0:
                solo_first_grad = one.trunk.weight.grad.clone()
        out["trunk_max_abs_diff"] = trunk_diff(net, one, grid)
        out["trunk_grad_rel_diff"] = trunk_grad_diff(first_grad, solo_first_grad, grid)
        out["trunk_worst_entry_first_grad"] = trunk_worst_grad(net, one, solo_first_grad, grid)
    return out


def main(num_envs=None, iters=None, quiet=False, rollout_len=16):
    ap = rank_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("num_envs", type=int, nargs="?", default=num_envs or 256)
    ap.add_argument("iters", type=int, nargs="?", default=iters or 12)
    ap.add_argument("--rollout-len", type=int, default=rollout_len)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    spawned = args.rank is None and "RANK" not in os.environ
    out = launch("apx_torch.examples.train_vtrace_mesh", args,
                 lambda grid, a: vtrace_check(grid, a.num_envs, a.rollout_len, a.iters, 4, a.seed),
                 [str(args.num_envs), str(args.iters), "--rollout-len", str(args.rollout_len),
                  "--seed", str(args.seed)])
    if spawned and not quiet:
        report(out, args.num_envs * args.rollout_len * args.iters, 4, "V-trace learner")
    return out["rewards"][-1]

if __name__ == "__main__":
    main()
