"""R2D2-style recurrent replay learner on the (data, model) grid (the twin
of apx's ``examples/train_r2d2_mesh.py``).

The third recipe beside PPO (on-policy) and V-trace (off-policy):
recurrent value learning from a DEVICE-RESIDENT replay ring.

* An LSTM agent state over the shared CNN/MLP encoder, apx's cell as
  written (gates i, f, g, o; the forget gate ``sigmoid(f + 1)``), with the
  initial recurrent state stored per sequence and a burn-in prefix
  replayed, detached, to warm it up before the learning window; carries are
  zeroed after a done step, in collection and in the unroll alike;
* the replay ring: (capacity, seq_len, N, ...) tensors on the device with
  ``ptr`` and ``filled`` device scalars; a write is an ``index_copy_`` at
  the pointer, sampling a uniform gather, with no host round trip;
* n-step double-Q targets (the online argmax, the target net's value) in
  the value-rescaled domain, h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x,
  positions within n steps of the sequence end masked out, and a target
  net synced every ``target_sync_every`` iterations;
* continuous env actions through a fixed 9-point codebook (stay + 8
  compass moves); the PREDICTION head stays continuous and trains through
  the env's differentiable loss term, as in the other recipes;
* on a grid (``train_ppo_mesh``) the env batch and the ring's env axis
  are data-parallel (``RING_ENV_AXIS``), the encoder and trunk
  tensor-parallel; the loss is a mean over the whole batch and the
  gradient is summed over the data ranks.

    python -m apx_torch.examples.train_r2d2_mesh [num_envs] [iterations]

launches as ``train_ppo_mesh`` does.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch
from torch import nn

from ..core.env import tree_map
from ..distrib.mesh import local_venv, shard_env_batch
from ..registry import _device as resolve_device
from .train_ppo_lidar import ClipAdam, PPONet, _grads_to_zero, _linear, init_net
from .train_ppo_mesh import (_sync, launch, rank_args, report, setup_rank, shard_net, trunk_diff,
                             trunk_grad_diff, trunk_worst_grad)
from .train_vtrace_mesh import clone_net

__all__ = ["N_ACTIONS", "ACTION_CODEBOOK", "value_rescale", "value_rescale_inv", "LSTMCell",
           "R2D2Net", "init_r2d2_net", "lstm_step", "agent_apply", "nstep_targets",
           "make_train_iter", "RING_ENV_AXIS", "ring_block", "r2d2_check", "main"]

N_ACTIONS = 9
_DIRS = np.zeros((N_ACTIONS, 2), np.float32)
_DIRS[1:] = [(np.cos(a), np.sin(a)) for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)]
ACTION_CODEBOOK = _DIRS  # (9, 2): stay + 8 compass moves (numpy; on the device per call)


def value_rescale(x, eps=1e-3):
    """R2D2 h(x) = sign(x)(sqrt(|x|+1)-1) + eps*x."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def value_rescale_inv(x, eps=1e-3):
    """Closed-form h^-1 (Kapturowski et al. 2019, appendix)."""
    a = (torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0) / (2.0 * eps)
    return torch.sign(x) * (a * a - 1.0)


class LSTMCell(nn.Module):
    """apx's cell: ``wx`` (d, 4H), ``wh`` (H, 4H), ``b`` (4H), apx's layout."""

    def __init__(self, d: int, hidden: int, device):
        super().__init__()
        self.wx = nn.Parameter(torch.empty((d, 4 * hidden), device=device))
        self.wh = nn.Parameter(torch.empty((hidden, 4 * hidden), device=device))
        self.b = nn.Parameter(torch.zeros(4 * hidden, device=device))


class R2D2Net(PPONet):
    """The PPO encoder and trunk, an LSTM cell, a Q head (9 actions) and a
    prediction head on the recurrent state; no policy or value head."""

    HEADS = {}

    def __init__(self, map_hw=(32, 32), hidden=128, device="cuda"):
        super().__init__(map_hw, device)
        device = resolve_device(device)
        self.hidden = hidden
        self.lstm = LSTMCell(256, hidden, device)
        self.q = _linear(hidden, N_ACTIONS, device)
        self.pred = _linear(hidden, 2, device)


def init_r2d2_net(generator: torch.Generator, map_hw=(32, 32), hidden=128,
                  device="cuda") -> R2D2Net:
    """apx's ``init_r2d2_net``: the PPO net's encoder and trunk
    (``init_net``), LSTM weights ``normal / sqrt(256 + hidden)``, Q and
    prediction weights ``normal * 0.01``, zero biases."""
    dev = resolve_device(device)
    base = init_net(generator, map_hw, dev)
    net = R2D2Net(map_hw, hidden, dev)
    keep = {k: v for k, v in base.state_dict().items() if k.split(".")[0] in
            ("conv1", "conv2", "map_proj", "prop", "trunk")}
    s = 1.0 / math.sqrt(256 + hidden)
    with torch.no_grad():
        net.load_state_dict(keep, strict=False)
        for p in (net.lstm.wx, net.lstm.wh):
            p.copy_(torch.randn(p.shape, generator=generator, device=dev) * s)
        net.lstm.b.zero_()
        for layer in (net.q, net.pred):
            w = torch.randn((layer.in_features, layer.out_features), generator=generator,
                            device=dev) * 0.01
            layer.weight.copy_(w.T)
            layer.bias.zero_()
    return net


def lstm_step(net: R2D2Net, carry, z):
    h, c = carry
    gates = z @ net.lstm.wx + h @ net.lstm.wh + net.lstm.b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def agent_apply(net: R2D2Net, obs, carry):
    """One recurrent step: obs -> (new_carry, q (.., A), pred (.., 2))."""
    carry, h = lstm_step(net, carry, net.encode(obs))
    return carry, net.q(h), torch.tanh(net.pred(h))


def nstep_targets(qs, qs_t, rew, done, gamma=0.99, nstep=3):
    """The n-step double-Q targets of apx's ``td_loss`` (L', B, N): online
    argmax ``qs``, target values ``qs_t`` (L', B, N, A), rewards and float
    dones (L', B, N); the return accumulated unrescaled, bootstrapped from
    ``value_rescale_inv`` of the target's value at t + nstep (the last
    position where that is past the end), and rescaled."""
    lp = qs.shape[0]
    a_star = torch.argmax(qs, dim=-1)
    q_boot = value_rescale_inv(torch.take_along_dim(qs_t, a_star[..., None], dim=-1)[..., 0])
    out = []
    for t in range(lp):
        g = torch.zeros_like(rew[0])
        alive = torch.ones_like(rew[0])
        for k in range(nstep):
            tk = min(t + k, lp - 1)
            valid = float(t + k < lp)
            g = g + alive * valid * (gamma ** k) * rew[tk]
            alive = alive * (1.0 - done[tk]) * valid
        g = g + alive * (gamma ** nstep) * q_boot[min(t + nstep, lp - 1)]
        out.append(value_rescale(g))
    return torch.stack(out)


# Env axis per ring field, by NAME: obs/act/rew/done are (C, L, N, ...),
# h0/c0 are (C, N, H), ptr/filled scalars. Matching on shape instead would
# misfire whenever hidden == num_envs.
RING_ENV_AXIS = {"obs": 2, "act": 2, "rew": 2, "done": 2, "h0": 1, "c0": 1}


def ring_block(ring: dict, sharding) -> dict:
    """A data rank's block of a whole ring: each field's env axis
    (``RING_ENV_AXIS``) cut to the rank's block, ``ptr``/``filled`` as they
    are."""
    def cut(x, ax):
        blk = sharding.block(x.shape[ax])
        return x.narrow(ax, blk.start, blk.stop - blk.start)

    return {k: v if k not in RING_ENV_AXIS else tree_map(lambda x, a=RING_ENV_AXIS[k]: cut(x, a), v)
            for k, v in ring.items()}


def make_train_iter(venv, opt: ClipAdam, num_envs, seq_len=16, burn_in=4, capacity=64,
                    batch_seqs=None, gamma=0.99, nstep=3, eps_greedy=0.1, pred_coef=1.0,
                    target_sync_every=4, hidden=128, grid=None):
    """One R2D2 iteration: collect a ``seq_len`` segment into the ring, then
    one double-Q learning step on ``batch_seqs`` sampled sequences.
    Returns ``(train_iter, empty_ring)``: ``empty_ring(obs)`` makes the ring
    of (capacity, seq_len, ...) zeros for this rank's obs; ``train_iter(net,
    target_net, opt_state, ring, env_state, obs, carry, it, generator,
    params, draws=None) -> (ring, env_state, obs, carry, it + 1,
    mean_reward)`` updates ``net``, ``opt_state`` and (every
    ``target_sync_every`` iterations) ``target_net`` in place. ``draws``
    injects what the iteration would take from ``generator``: per step of
    the segment ``rand`` (T, N) the random action ids, ``explore`` (T, N)
    the uniforms compared with ``eps_greedy`` and ``reset`` a list of T
    reset-draw dicts of all N envs; ``idx`` (batch_seqs,) the sampled ring
    rows."""
    batch_seqs = batch_seqs or max(2, capacity // 8)
    env = venv.env
    local = venv if grid is None else local_venv(venv, grid.env)

    def block(tree):
        return tree if grid is None else shard_env_batch(grid.env, tree)

    def data_sum(x):
        return x if grid is None else grid.data_sum(x)

    def empty_ring(obs_example):
        n = next(iter(obs_example.values())).shape[0]
        dev = next(iter(obs_example.values())).device
        seq_of = lambda x: torch.zeros((capacity, seq_len) + tuple(x.shape), dtype=x.dtype,
                                       device=dev)
        return {
            "obs": tree_map(seq_of, obs_example),
            "act": torch.zeros((capacity, seq_len, n), dtype=torch.int64, device=dev),
            "rew": torch.zeros((capacity, seq_len, n), dtype=torch.float32, device=dev),
            "done": torch.zeros((capacity, seq_len, n), dtype=torch.bool, device=dev),
            "h0": torch.zeros((capacity, n, hidden), dtype=torch.float32, device=dev),
            "c0": torch.zeros((capacity, n, hidden), dtype=torch.float32, device=dev),
            "ptr": torch.zeros((), dtype=torch.int64, device=dev),
            "filled": torch.zeros((), dtype=torch.int64, device=dev),
        }

    def unroll(net, carry, obs_seq, done_seq):
        """obs_seq (B, L, n, ...) -> (carry, qs (L, B, n, A)); carries zeroed
        after done steps, as in collection."""
        b, n = done_seq.shape[0], done_seq.shape[2]
        qs = []
        for t in range(done_seq.shape[1]):
            o = tree_map(lambda x: x[:, t].reshape((b * n,) + x.shape[3:]), obs_seq)
            (h, c), q, _ = agent_apply(net, o, tuple(x.reshape(b * n, -1) for x in carry))
            keep = ~done_seq[:, t].reshape(b * n, 1)
            carry = (torch.where(keep, h, 0.0).reshape(b, n, -1),
                     torch.where(keep, c, 0.0).reshape(b, n, -1))
            qs.append(q.reshape(b, n, -1))
        return carry, torch.stack(qs)

    def train_iter(net, target_net, opt_state, ring, env_state, obs, carry, it, generator,
                   params, draws=None):
        dev = params.device
        h0, c0 = carry
        codebook = torch.from_numpy(ACTION_CODEBOOK).to(dev)
        # ---- collect one segment with the ONLINE net (eps-greedy on the
        # codebook; the prediction head trains through the reward) -------
        obs_t, act_t, r_t, done_t = [], [], [], []
        st = env_state
        for t in range(seq_len):
            carry, q, pred = agent_apply(net, obs, carry)
            if draws is not None:
                rand, u = draws["rand"][t], draws["explore"][t]
            else:
                rand = torch.randint(0, N_ACTIONS, (num_envs,), generator=generator, device=dev)
                u = torch.rand((num_envs,), generator=generator, device=dev)
            act_id = torch.where(block(u) < eps_greedy, block(rand), torch.argmax(q, dim=-1))
            step_draws = block(env.draw_step(num_envs, params, generator))
            reset = block(draws["reset"][t] if draws is not None
                          else env.draw_reset(num_envs, params, generator))
            obs2, st, r, te, tr, _ = local.step(
                st, {"action": codebook[act_id], "prediction": pred}, params,
                reset_draws=reset, step_draws=step_draws)
            done = te | tr
            # Fresh recurrent state at episode starts: zero the carry of envs
            # that just finished (they autoreset on the next step).
            carry = tuple(torch.where(done[:, None], 0.0, x).detach() for x in carry)
            obs_t.append(obs)
            act_t.append(act_id)
            r_t.append(r)
            done_t.append(done)
            obs = obs2
        r_t = torch.stack(r_t)
        _grads_to_zero(net)
        (-pred_coef * r_t.sum() / (seq_len * num_envs)).backward()  # the prediction gradient
        r_t = r_t.detach()

        # ---- write the segment at the ring pointer ----------------------
        with torch.no_grad():
            ptr = ring["ptr"].reshape(1)
            seg = {"obs": tree_map(lambda *xs: torch.stack(xs), *obs_t),
                   "act": torch.stack(act_t), "rew": r_t, "done": torch.stack(done_t),
                   "h0": h0, "c0": c0}
            for k, v in seg.items():
                tree_map(lambda buf, x: buf.index_copy_(0, ptr, x[None].to(buf.dtype)), ring[k], v)
            ring["ptr"] = (ring["ptr"] + 1) % capacity
            ring["filled"] = torch.clamp(ring["filled"] + 1, max=capacity)

            # ---- sample sequences ---------------------------------------
            if draws is not None:
                idx = draws["idx"]
            else:
                u = torch.rand((batch_seqs,), generator=generator, device=dev)
                idx = (u * torch.clamp(ring["filled"], min=1)).to(torch.int64)
            seq = {k: tree_map(lambda x: x.index_select(0, idx), ring[k])
                   for k in ("obs", "act", "rew", "done", "h0", "c0")}
            burn = tree_map(lambda x: x[:, :burn_in], seq["obs"])
            main = tree_map(lambda x: x[:, burn_in:], seq["obs"])
            burn_done, main_done = seq["done"][:, :burn_in], seq["done"][:, burn_in:]
            carry0 = (seq["h0"], seq["c0"])
            # Burn-in, detached, warms the recurrent state; the target net's
            # unroll takes no gradient.
            carry_b, _ = unroll(net, carry0, burn, burn_done)
            carry_bt, _ = unroll(target_net, carry0, burn, burn_done)
            _, qs_t = unroll(target_net, carry_bt, main, main_done)

        # ---- n-step double-Q ---------------------------------------------
        _, qs = unroll(net, carry_b, main, main_done)  # (L', B, n, A)
        act = seq["act"][:, burn_in:].transpose(0, 1)
        rew = seq["rew"][:, burn_in:].transpose(0, 1)
        done = seq["done"][:, burn_in:].transpose(0, 1).to(torch.float32)
        q_sa = torch.take_along_dim(qs, act[..., None], dim=-1)[..., 0]
        targets = nstep_targets(qs.detach(), qs_t, rew, done, gamma, nstep)
        td = q_sa - targets
        lp = qs.shape[0]
        # Positions within nstep of the sequence end have no valid bootstrap.
        t_mask = (torch.arange(lp, device=dev) < lp - nstep).to(torch.float32)[:, None, None]
        loss = 0.5 * (td * td * t_mask).sum() / (t_mask.sum() * batch_seqs * num_envs)
        loss.backward()
        if grid is not None:
            grid.reduce_grads(list(net.parameters()))
        opt.step(opt_state, grid)

        if (it + 1) % target_sync_every == 0:
            with torch.no_grad():
                for t, p in zip(target_net.parameters(), net.parameters()):
                    t.copy_(p)
        return ring, st, obs, carry, it + 1, data_sum(r_t.sum()) / (seq_len * num_envs)

    return train_iter, empty_ring


def r2d2_check(grid, num_envs: int, iters: int = 2, hidden: int = 32, seq_len: int = 6,
               burn_in: int = 2, capacity: int = 4, batch_seqs: int | None = 2,
               target_sync_every: int = 2, seed: int = 31, solo: bool = False) -> dict:
    """``iters`` R2D2 iterations on the grid: the rewards, the ring's
    ``ptr`` and ``filled``, whether the target net equals the online one,
    the ring's local env axis. With ``solo`` also the same iterations in
    one process (this rank, the whole batch, a generator seeded alike): its
    rewards, the largest |difference| of this rank's ``trunk.w`` rows from
    its net's same rows, and of their first iteration's gradients
    (``trunk_grad_diff``)."""
    opt = ClipAdam(1.0, 1e-3)
    init = lambda gen, hw, dev: init_r2d2_net(gen, hw, hidden, dev)  # noqa: E731
    venv, params, obs, state, g, net = setup_rank(grid, num_envs, seed, init=init)
    shard_net(net, grid)
    kw = dict(seq_len=seq_len, burn_in=burn_in, capacity=capacity, batch_seqs=batch_seqs,
              target_sync_every=target_sync_every, hidden=hidden)

    def run(net, obs, state, g, grid=None):
        target, opt_state = clone_net(net), opt.init(net)
        train_iter, empty_ring = make_train_iter(venv, opt, num_envs, grid=grid, **kw)
        ring = empty_ring(obs)
        n = next(iter(obs.values())).shape[0]
        carry = (torch.zeros((n, hidden), device=params.device),
                 torch.zeros((n, hidden), device=params.device))
        it, rewards = 0, []
        for i in range(iters):
            ring, state, obs, carry, it, mean_r = train_iter(net, target, opt_state, ring, state,
                                                             obs, carry, it, g, params)
            rewards.append(float(mean_r))
            if i == 0:
                first_grad = net.trunk.weight.grad.clone()
        return rewards, ring, target, first_grad

    _sync(grid.device)
    t0 = time.perf_counter()
    rewards, ring, target, first_grad = run(net, obs, state, g, grid)
    _sync(grid.device)
    out = {"rewards": rewards, "ptr": int(ring["ptr"]), "filled": int(ring["filled"]),
           "target_equals_online": all(torch.equal(a, b) for a, b in
                                       zip(net.parameters(), target.parameters())),
           "ring_envs": int(ring["act"].shape[2]), "trunk_shape": list(net.trunk.weight.shape),
           "seconds": time.perf_counter() - t0}
    if solo:
        solo_g = torch.Generator(grid.device).manual_seed(seed)
        obs, state, _ = venv.reset(params, solo_g)
        one = init(solo_g, params.map_bank.map_hw, grid.device)
        out["solo_rewards"], _, _, solo_first_grad = run(one, obs, state, solo_g)
        out["trunk_max_abs_diff"] = trunk_diff(net, one, grid)
        out["trunk_grad_rel_diff"] = trunk_grad_diff(first_grad, solo_first_grad, grid)
        out["trunk_worst_entry_first_grad"] = trunk_worst_grad(net, one, solo_first_grad, grid)
    return out


def main(num_envs=None, iters=None, quiet=False):
    ap = rank_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("num_envs", type=int, nargs="?", default=num_envs or 128)
    ap.add_argument("iters", type=int, nargs="?", default=iters or 10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    spawned = args.rank is None and "RANK" not in os.environ
    out = launch("apx_torch.examples.train_r2d2_mesh", args,
                 lambda grid, a: r2d2_check(grid, a.num_envs, a.iters, hidden=128, seq_len=16,
                                            burn_in=4, capacity=64, batch_seqs=None,
                                            target_sync_every=4, seed=a.seed),
                 [str(args.num_envs), str(args.iters), "--seed", str(args.seed)])
    if spawned and not quiet:
        report(out, args.num_envs * 16 * args.iters, 4, "replay + recurrent learner")
    return out["rewards"][-1]

if __name__ == "__main__":
    main()
