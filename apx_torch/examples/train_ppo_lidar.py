"""End-to-end training: PPO + prediction head on LIDARLocRooms (the twin of
apx's ``examples/train_ppo_lidar.py``).

* A CNN map encoder (the 32x32 occupancy bitmap through two strided
  convolutions) fused with an MLP over lidar, odometry and time;
* PPO: GAE(lambda), the clipped surrogate, an entropy bonus, value
  clipping, ``epochs`` x ``num_minibatches`` updates per rollout;
* the prediction head trains THROUGH the env's differentiable loss term
  (the active-perception contract): the composite reward's -loss term
  backpropagates into the prediction MLP and the encoder under it, while
  the policy trains on the score function with its actions detached
  before the env step. Every step of the rollout runs the env's raycast
  kernels; the gradient never crosses them.

The iteration keeps apx's order: the rollout and its prediction gradient,
GAE by a reverse loop, advantage normalization, ONE optimizer step on the
prediction gradient, then the PPO minibatch steps, all on one optimizer.
The optimizer is ``optax.chain(clip_by_global_norm(0.5), adam(3e-4))``
as optax computes it (``ClipAdam``). Every random draw comes from the
caller's ``torch.Generator`` on the run's device, or is injected
(``draws``), so a test can feed the draws apx made from its keys.

    python -m apx_torch.examples.train_ppo_lidar [num_envs] [iterations]

``make_train_iter(..., grid=...)`` runs the same iteration as one rank of
a (data, model) grid (``train_ppo_mesh``).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.env import tree_map
from ..distrib.mesh import local_venv, shard_env_batch
from ..registry import _device as resolve_device
from ..registry import make_vec

__all__ = ["PPONet", "init_net", "encode", "policy_dist", "logp_gauss",
           "ClipAdam", "gae", "ppo_loss", "make_train_iter", "trainer_state", "load_trainer_state",
           "resume_check", "main"]

# jnp.log(2 * jnp.pi) and jnp.log(2 * jnp.pi * jnp.e): float32 constants.
LOG_2PI = float(np.log(np.float32(2 * np.pi)))
LOG_2PIE = float(np.log(np.float32(2 * np.pi * np.e)))


# ---------------------------------------------------------------------------
# Network: CNN map encoder + proprioceptive MLP trunk


def _linear(fan_in: int, fan_out: int, device) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out, device=device)


def _conv(cin: int, cout: int, device) -> nn.Conv2d:
    return nn.utils.skip_init(nn.Conv2d, cin, cout, 3, stride=2, device=device)


class PPONet(nn.Module):
    """apx's PPO net; submodules named as apx's dict keys. Weights are
    (out, in) and OIHW, apx's transposed (``convert.ppo_net_from_numpy``).
    Built uninitialized; ``init_net`` draws apx's initialization."""

    HEADS = {"policy": 4, "value": 1, "pred": 2}  # mean(2) + logstd(2); value; prediction

    def __init__(self, map_hw=(32, 32), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        h, w = map_hw
        self.map_hw = (h, w)
        self.conv1 = _conv(1, 16, device)
        self.conv2 = _conv(16, 32, device)
        self.map_proj = _linear((h // 4) * (w // 4) * 32, 128, device)
        self.prop = _linear(11, 128, device)  # lidar(8) + odometry(2) + time(1)
        self.trunk = _linear(256, 256, device)
        for name, width in self.HEADS.items():
            setattr(self, name, _linear(256, width, device))

    def encode_parts(self, obs):
        """(the proprioceptive input (N, 11), the flattened map features
        (N, 2048) in apx's NHWC order)."""
        parts = [obs["lidar"], obs["odometry"], obs["time_step"][..., None]]
        x = obs["map"] * 255.0  # {0, 1/255} bitmap -> {0, 1}
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in (self.conv1, self.conv2):
            # JAX's "SAME" at stride 2 pads an even input (0, 1): low 0, high 1.
            x = torch.tanh(conv(F.pad(x, (0, 1, 0, 1))))
        return torch.cat(parts, dim=-1), x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    # The (data, model) grid of a tensor-parallel shard (``train_ppo_mesh.
    # shard_net``): ``prop`` and ``map_proj`` hold this rank's output
    # columns, ``trunk`` its input rows; None for the whole net.
    grid = None

    def encode(self, obs):
        prop_in, flat = self.encode_parts(obs)
        if self.grid is None:
            z = torch.cat([torch.tanh(self.prop(prop_in)), torch.tanh(self.map_proj(flat))], -1)
            return torch.tanh(self.trunk(z))
        # Megatron's f before the column-parallel projections (the encoder's
        # gradient summed over the model ranks), g after the row-parallel
        # trunk (its partial products summed), then the replicated bias.
        flat = self.grid.copy_to_model(flat)
        z = torch.cat([torch.tanh(self.prop(prop_in)), torch.tanh(self.map_proj(flat))], -1)
        partial = F.linear(z, self.trunk.weight)
        return torch.tanh(self.grid.reduce_from_model(partial) + self.trunk.bias)


def init_net(generator: torch.Generator, map_hw=(32, 32), device="cuda") -> PPONet:
    """apx's ``init_net``: weights ``normal * sqrt(2 / fan_in)``, zero biases,
    drawn from ``generator`` in apx's key order."""
    net = PPONet(map_hw, device)
    dev = resolve_device(device)
    with torch.no_grad():
        for name in ("conv1", "conv2", "map_proj", "prop", "trunk", "policy", "value", "pred"):
            layer = getattr(net, name)
            fan_in = math.prod(layer.weight.shape[1:])
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator, device=dev)
                               * math.sqrt(2.0 / fan_in))
            layer.bias.zero_()
    return net


def encode(net: PPONet, obs):
    return net.encode(obs)


def policy_dist(net: PPONet, z):
    out = net.policy(z)
    return out[..., :2], torch.clamp(out[..., 2:], -3.0, 0.0)


def logp_gauss(a, mean, logstd):
    return -0.5 * (((a - mean) / torch.exp(logstd)) ** 2 + 2 * logstd + LOG_2PI).sum(dim=-1)


# ---------------------------------------------------------------------------
# Optimizer


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))``: ``init``
    makes the state (a ``torch.optim.Adam`` with eps 1e-8, its moments and
    step made at once, so a fresh state has every leaf a checkpoint
    carries), ``step`` applies one update from the parameters' ``.grad``.
    The clip is optax's: ``g`` when the global norm is below ``max_norm``,
    else ``g / norm * max_norm`` (``clip_grad_norm_`` scales by
    ``max / (norm + 1e-6)``, another function). torch's Adam and optax's
    place the bias corrections differently around eps: rounding only."""

    max_norm: float = 0.5
    lr: float = 3e-4

    def init(self, net: nn.Module) -> torch.optim.Adam:
        opt = torch.optim.Adam(net.parameters(), lr=self.lr, eps=1e-8)
        for p in net.parameters():
            opt.state[p] = {"step": torch.tensor(0.0, dtype=torch.get_default_dtype()),
                            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                            "exp_avg_sq": torch.zeros_like(p,
                                                           memory_format=torch.preserve_format)}
        return opt

    def step(self, opt: torch.optim.Adam, grid=None) -> None:
        params = [p for group in opt.param_groups for p in group["params"]]
        with torch.no_grad():
            if grid is None:
                sq = sum(torch.sum(p.grad * p.grad) for p in params)
            else:
                sq = grid.sq_norm(params)
            norm = torch.sqrt(sq)
            keep = norm < self.max_norm
            for p in params:
                p.grad = torch.where(keep, p.grad, p.grad / norm * self.max_norm)
        opt.step()


def _grads_to_zero(net: nn.Module) -> None:
    for p in net.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()


# ---------------------------------------------------------------------------


def gae(r_t, v_t, done_t, v_last, gamma=0.99, lam=0.95):
    """GAE(lambda) by a reverse loop over (T, N) rewards, values and dones:
    (advantages, returns)."""
    adv_t = torch.empty_like(r_t)
    adv_next, v_next = torch.zeros_like(v_last), v_last
    for t in reversed(range(r_t.shape[0])):
        nonterm = 1.0 - done_t[t].to(torch.float32)
        delta = r_t[t] + gamma * v_next * nonterm - v_t[t]
        adv_next = delta + gamma * lam * nonterm * adv_next
        adv_t[t], v_next = adv_next, v_t[t]
    return adv_t, adv_t + v_t


def ppo_loss(net, mb_data, mb: int, clip_eps=0.2, vf_coef=0.5, ent_coef=1e-3):
    """The clipped PPO loss of a minibatch of ``mb`` rows, of which
    ``mb_data`` (obs, a_raw, logp_old, adv, ret, v_old) holds this rank's
    share: its sums are divided by ``mb``, so the ranks' losses add up to
    the minibatch mean."""
    o, a_raw, logp_old, adv, ret, v_old = mb_data
    z = net.encode(o)
    mean, logstd = policy_dist(net, z)
    logp = logp_gauss(a_raw, mean, logstd)
    ratio = torch.exp(logp - logp_old)
    pg = -torch.minimum(ratio * adv,
                        torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv).sum() / mb
    v = net.value(z)[..., 0]
    v_clip = v_old + torch.clamp(v - v_old, -clip_eps, clip_eps)
    vloss = 0.5 * torch.maximum((v - ret) ** 2, (v_clip - ret) ** 2).sum() / mb
    ent = (logstd + 0.5 * LOG_2PIE).sum(dim=-1).sum() / mb
    return pg + vf_coef * vloss - ent_coef * ent


class _Clock:
    """Host seconds between laps, the device synchronised at each, written
    into ``stats`` (nothing is timed or synchronised without it)."""

    def __init__(self, device: torch.device, stats: dict | None):
        self.device, self.stats = device, stats
        self.t = self._now() if stats is not None else None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        if self.stats is not None:
            t = self._now()
            self.stats[name], self.t = t - self.t, t


def make_train_iter(
    venv,
    opt: ClipAdam,
    num_envs,
    rollout_len=32,
    gamma=0.99,
    lam=0.95,
    clip_eps=0.2,
    ent_coef=1e-3,
    vf_coef=0.5,
    pred_coef=1.0,
    epochs=2,
    num_minibatches=4,
    grid=None,
):
    """One full PPO iteration (rollout + GAE + ``epochs`` x
    ``num_minibatches`` minibatch updates), apx's ``make_train_iter``.

    Returns ``train_iter(net, opt_state, env_state, obs, generator, params,
    draws=None) -> (env_state, obs, mean_reward)``, which updates ``net``
    and ``opt_state`` (``opt.init(net)``) in place. ``draws`` injects what
    the iteration would take from ``generator``: ``noise`` (T, N, 2) the
    action noise, ``reset`` a list of T reset-draw dicts (the env's
    ``draw_reset`` of all N envs per step), ``perm`` (epochs *
    num_minibatches, mb) the minibatch rows. A ``stats`` dict receives the
    prediction loss, the squared norm of the prediction gradient per
    submodule, the PPO minibatch losses and the seconds of the rollout
    (with its prediction backward) and of the update, the device
    synchronised between them.

    With a ``grid`` (``train_ppo_mesh.make_dp_tp_grid``) the call is one
    rank of the dp x tp program: ``net`` is its tensor-parallel shard,
    ``env_state`` and ``obs`` its data block; draws are of the whole
    batch, of which it keeps its block; the means are over the whole
    batch; the rollout is gathered over the data ranks once, so that the
    minibatches are those of the one-process run, each split over the
    data ranks; gradients are summed over them.
    """
    env = venv.env
    n = rollout_len * num_envs
    mb = n // num_minibatches
    local = venv if grid is None else local_venv(venv, grid.env)

    def block(tree):
        return tree if grid is None else shard_env_batch(grid.env, tree)

    def data_sum(x):
        return x if grid is None else grid.data_sum(x)

    def reduce_grads(net):
        if grid is not None:
            grid.reduce_grads(list(net.parameters()))

    def train_iter(net, opt_state, env_state, obs, generator, params, draws=None, stats=None):
        dev = params.device
        clock = _Clock(dev, stats)
        # ---- collect one rollout (prediction head trains through the
        # differentiable -loss term inside the composite reward) ----------
        obs_t, araw_t, r_t, done_t = [], [], [], []
        st = env_state
        for t in range(rollout_len):
            z = net.encode(obs)
            mean, logstd = policy_dist(net, z)
            noise = (draws["noise"][t] if draws is not None
                     else torch.randn((num_envs, 2), generator=generator, device=dev))
            a_raw = mean + torch.exp(logstd) * block(noise)
            a = torch.tanh(a_raw)
            pred = torch.tanh(net.pred(z))
            step_draws = block(env.draw_step(num_envs, params, generator))
            reset = (draws["reset"][t] if draws is not None
                     else env.draw_reset(num_envs, params, generator))
            obs2, st, r, te, tr, _ = local.step(
                st, {"action": a.detach(), "prediction": pred}, params,
                reset_draws=block(reset), step_draws=step_draws)
            obs_t.append(obs)
            araw_t.append(a_raw.detach())
            r_t.append(r)
            done_t.append(te | tr)
            obs = obs2
        r_t = torch.stack(r_t)
        # Mean composite reward: its -loss term is differentiable in the
        # prediction head and the encoder under it.
        _grads_to_zero(net)
        pred_loss = -pred_coef * r_t.sum() / n
        pred_loss.backward()
        clock.lap("rollout_s")
        r_t = r_t.detach()
        obs_t = tree_map(lambda *xs: torch.stack(xs), *obs_t)
        araw_t, done_t = torch.stack(araw_t), torch.stack(done_t)
        t_len, n_local = r_t.shape

        with torch.no_grad():
            # ---- GAE over the collected rollout --------------------------
            flat = tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), obs_t)
            z_t = net.encode(flat)
            v_t = net.value(z_t)[..., 0].reshape(t_len, n_local)
            v_last = net.value(net.encode(obs))[..., 0]
            mean_t, logstd_t = policy_dist(net, z_t.reshape(t_len, n_local, -1))
            logp_t = logp_gauss(araw_t, mean_t, logstd_t)
            adv_t, ret_t = gae(r_t, v_t, done_t, v_last, gamma, lam)
            # Population statistics over the whole batch, as jnp.std.
            adv_mean = data_sum(adv_t.sum()) / n
            adv_std = torch.sqrt(data_sum(((adv_t - adv_mean) ** 2).sum()) / n)
            adv_t = (adv_t - adv_mean) / (adv_std + 1e-8)
            mean_reward = data_sum(r_t.sum()) / n

            batch = (obs_t, araw_t, logp_t, adv_t, ret_t, v_t)
            if grid is not None:
                batch = grid.gather_envs(batch)  # (T, N, ...) of every data rank
            batch = tree_map(lambda x: x.reshape((n,) + x.shape[2:]), batch)

        # ---- PPO epochs x minibatches ------------------------------------
        if draws is not None:
            idxs = draws["perm"].to(dev)
        else:
            idxs = torch.stack([torch.randperm(n, generator=generator, device=dev)
                                .reshape(num_minibatches, mb) for _ in range(epochs)])
            idxs = idxs.reshape(epochs * num_minibatches, mb)

        # Apply the prediction-head gradients once per iteration.
        reduce_grads(net)
        if stats is not None:
            stats["pred_grad_sq"] = {name: sum(torch.sum(p.grad * p.grad)
                                               for p in layer.parameters())
                                     for name, layer in net.named_children()}
        opt.step(opt_state, grid)
        losses = []
        for idx in idxs:
            if grid is not None:
                idx = grid.env.local(idx)  # this data rank's rows of the minibatch
            mb_data = tree_map(lambda x: x[idx], batch)
            _grads_to_zero(net)
            loss = ppo_loss(net, mb_data, mb, clip_eps, vf_coef, ent_coef)
            loss.backward()
            losses.append(loss.detach())
            reduce_grads(net)
            opt.step(opt_state, grid)
        clock.lap("update_s")
        if stats is not None:
            stats["pred_loss"] = float(pred_loss.detach())
            stats["pred_grad_sq"] = {k: float(v) for k, v in stats["pred_grad_sq"].items()}
            stats["ppo_losses"] = [float(x) for x in losses]
        return st, obs, mean_reward

    return train_iter


# ---------------------------------------------------------------------------
# Checkpoint leaves of the trainer


def trainer_state(net: nn.Module, opt_state: torch.optim.Adam, env_state, obs,
                  generator: torch.Generator) -> dict:
    """Everything a resumed run needs, as a tree of tensors for
    ``utils.checkpoint.save_state``: the net's weights, Adam's step and
    moments (in parameter order), the env state, the obs and the
    generator's state."""
    params = list(net.parameters())
    return {"net": dict(net.state_dict()),
            "adam": {k: [opt_state.state[p][k] for p in params]
                     for k in ("step", "exp_avg", "exp_avg_sq")},
            "env_state": env_state, "obs": obs, "generator": generator.get_state()}


def load_trainer_state(tree: dict, net: nn.Module, opt_state: torch.optim.Adam,
                       generator: torch.Generator):
    """Load ``trainer_state``'s tree (``restore_state``'s result) into
    ``net``, ``opt_state`` and ``generator``; returns (env_state, obs)."""
    net.load_state_dict(tree["net"])
    for i, p in enumerate(net.parameters()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            opt_state.state[p][k] = tree["adam"][k][i]
    generator.set_state(tree["generator"])
    return tree["env_state"], tree["obs"]


def resume_check(venv, params, num_envs: int, rollout_len: int, path: str,
                 num_minibatches: int = 4, seeds: tuple[int, int] = (11, 12)) -> dict:
    """A trainer checkpointed and resumed against the uninterrupted run
    (apx's ``test_learner_checkpoint_resume_bit_identical``): two
    iterations, ``trainer_state`` saved to ``path``, two more; a trainer
    made from another seed restored from ``path`` and run two iterations.
    Returns whether every leaf of the two trainers' states (net, Adam's
    step and moments, env state, obs, generator) is bitwise equal, the
    number of leaves and the indices of those that differ."""
    from ..utils.checkpoint import restore_state, save_state

    opt = ClipAdam()
    train_iter = make_train_iter(venv, opt, num_envs, rollout_len,
                                 num_minibatches=num_minibatches)
    dev = params.device

    def fresh(seed):
        g = torch.Generator(dev).manual_seed(seed)
        obs, state, _ = venv.reset(params, g)
        net = init_net(g, params.map_bank.map_hw, dev)
        return net, opt.init(net), state, obs, g

    def run(iters, net, opt_state, state, obs, g):
        for _ in range(iters):
            state, obs, _ = train_iter(net, opt_state, state, obs, g, params)
        return state, obs

    def leaves(net, opt_state, state, obs, g):
        out = []
        tree_map(lambda x: out.append(x.detach().cpu().reshape(-1).view(torch.uint8)),
                 trainer_state(net, opt_state, state, obs, g))
        return out

    net, opt_state, state, obs, g = fresh(seeds[0])
    state, obs = run(2, net, opt_state, state, obs, g)
    save_state(path, trainer_state(net, opt_state, state, obs, g))
    want = leaves(net, opt_state, *run(2, net, opt_state, state, obs, g), g)
    net_b, opt_b, like_state, like_obs, g_b = fresh(seeds[1])
    state_b, obs_b = load_trainer_state(
        restore_state(path, trainer_state(net_b, opt_b, like_state, like_obs, g_b)),
        net_b, opt_b, g_b)
    got = leaves(net_b, opt_b, *run(2, net_b, opt_b, state_b, obs_b, g_b), g_b)
    differing = [i for i, (a, b) in enumerate(zip(want, got)) if not torch.equal(a, b)]
    return {"bitwise": len(want) == len(got) and not differing, "leaves": len(want),
            "differing": differing}


def main(num_envs=None, iters=None, quiet=False, device="cuda", seed=0):
    num_envs = num_envs or (int(sys.argv[1]) if len(sys.argv) > 1 else 1024)
    iters = iters or (int(sys.argv[2]) if len(sys.argv) > 2 else 40)
    dev = resolve_device(device)

    venv, params = make_vec("LIDARLocRooms-v0", num_envs, device=dev)
    g = torch.Generator(dev).manual_seed(seed)
    obs, env_state, _ = venv.reset(params, g)
    net = init_net(g, params.map_bank.map_hw, dev)
    opt = ClipAdam(0.5, 3e-4)
    opt_state = opt.init(net)

    rollout_len = 32
    train_iter = make_train_iter(venv, opt, num_envs, rollout_len)

    t0 = time.perf_counter()
    mean_r = None
    for i in range(iters):
        env_state, obs, mean_r = train_iter(net, opt_state, env_state, obs, g, params)
        if not quiet and (i % 5 == 0 or i == iters - 1):
            print(f"iter {i}: mean step reward {float(mean_r):+.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sps = num_envs * rollout_len * iters / (time.perf_counter() - t0)
    if not quiet:
        print(f"{sps:,.0f} env-steps/s including learner update")
    return float(mean_r)


if __name__ == "__main__":
    main()
