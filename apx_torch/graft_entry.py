"""Entry points of the port: the flagship step and the multi-rank dry
run (the twin of apx's ``__graft_entry__.py``).

``entry()`` returns the vector step of the flagship CircleSquare
classification env (N = 64, 16x16 images; the glimpse kernel and the loss
composition) with example arguments.

``dryrun_multichip(world)`` runs ``world`` ranks on a (data, model) grid
(``examples.train_ppo_mesh.make_dp_tp_grid``) and checks, on tiny shapes,
the paths the headline numbers use:

1. the LIDARLocRooms sharded rollout (``distrib.sharded_rollout``, the env
   batch over the data ranks), sharded == one-process;
2. the episodic LOCKSTEP sharded rollout (the image-env path), the same;
3. one training step: a 3-step rollout of the data-sharded env feeding an
   MLP tensor-parallel over the model ranks (hidden 8 x model), REINFORCE
   plus the prediction MSE, and an SGD step at lr 1e-3; the sharded loss
   equals the one-process loss (rtol 1e-5) and is finite, and the sharded
   step the one-process step (within 1e-5 of its largest entry).

apx's check 3 differentiates its loss through the env with the action
live: the prediction target (the agent's position) moves with the action,
and the move is clipped by a raycast. At the dry run's sizes that gradient
is NaN in every entry of ``w1``, ``b1`` and ``w_act`` (apx asserts only
that the loss is finite). The port therefore follows apx's loss with the
env's action under ``stop_gradient``: it steps the env with the action
detached, as the recipes do (K1 has no backward), and ``train_step``,
given apx's draws, equals that loss and SGD step
(``tests/test_torch_graft_entry.py``). The check holds the sharded loss
and step to the one-process run's (``step_rel_diff``).

    python -m apx_torch.graft_entry [--world W] [--device cuda:0] [--backend gloo]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

import torch
import torch.distributed as dist

from .core.env import AutoResetMode, rollout, rollout_episodic, vector_env
from .distrib.mesh import local_venv, shard_env_batch, sharded_rollout
from .registry import _device as resolve_device

__all__ = ["entry", "dryrun_multichip", "step_draws", "train_step", "train_step_check",
           "main"]

ROLLOUT = 3
LR = 1e-3


def _make_flagship(num_envs: int, device):
    from .data.circle_square import make_circle_square_bank
    from .envs.image_classification import ImageClassificationEnv

    env = ImageClassificationEnv(dataset=make_circle_square_bank((16, 16), device=device))
    return vector_env(env, num_envs, AutoResetMode.LOCKSTEP), env.default_params()


def entry(device="cuda"):
    """(fn, example_args): the flagship env's vector step at N = 64,
    ``fn(generator, state, full_action, params) -> (obs, state, reward,
    terminated, truncated)``, with its reset state and zero actions."""
    num_envs = 64
    dev = resolve_device(device)
    venv, params = _make_flagship(num_envs, dev)

    def fn(generator, state, full_action, params):
        obs, state2, reward, term, trunc, _ = venv.step(state, full_action, params, generator)
        return obs, state2, reward, term, trunc

    g = torch.Generator(dev).manual_seed(0)
    _, state0, _ = venv.reset(params, g)
    full_action = {"action": torch.zeros((num_envs, 2), device=dev),
                   "prediction": torch.zeros((num_envs, 2), device=dev)}
    return fn, (g, state0, full_action, params)


def _make_headline(num_envs: int, device):
    """Tiny-shape LIDARLocRooms (the wrapper stack and autoreset of the
    headline env, 4 rooms maps of 16x16, 4-step episodes)."""
    from .data.floor_map import make_rooms_bank
    from .envs.lidar_localization import LIDARLocalizationEnv
    from .wrappers.time_limit import TimeLimit

    env = TimeLimit(LIDARLocalizationEnv(
        map_bank=make_rooms_bank(num_maps=4, width=16, height=16, device=device)),
        4, issue_termination=True)
    return vector_env(env, num_envs, AutoResetMode.NEXT_STEP), env.default_params()


def _flat_obs(obs) -> torch.Tensor:
    """The obs leaves in apx's tree order (sorted keys), flattened."""
    n = next(iter(obs.values())).shape[0]
    return torch.cat([obs[k].reshape(n, -1).to(torch.float32) for k in sorted(obs)], dim=-1)


def _mlp_init(generator, d_in, d_hidden, d_act, d_pred, device) -> dict:
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return {"w1": normal(d_in, d_hidden) / math.sqrt(d_in),
            "b1": torch.zeros(d_hidden, device=device),
            "w_act": normal(d_hidden, d_act) * 0.01,
            "w_pred": normal(d_hidden, d_pred) * 0.01}


def _mlp_apply(w: dict, x, grid=None):
    """(action mean, prediction). On a grid ``w1`` and ``b1`` hold this
    model rank's hidden columns and ``w_act``/``w_pred`` its rows: the
    outputs' partial products are summed over the model ranks."""
    h = torch.tanh(x @ w["w1"] + w["b1"])
    act, pred = h @ w["w_act"], h @ w["w_pred"]
    if grid is not None:
        act, pred = grid.reduce_from_model(act), grid.reduce_from_model(pred)
    return torch.tanh(act), pred


def _shard_mlp(w: dict, grid) -> dict:
    cols = slice(grid.m * w["b1"].shape[0] // grid.model,
                 (grid.m + 1) * w["b1"].shape[0] // grid.model)
    return {"w1": w["w1"][:, cols], "b1": w["b1"][cols], "w_act": w["w_act"][cols],
            "w_pred": w["w_pred"][cols]}


def step_draws(env, params, num_envs: int, generator) -> dict:
    """The draws of one dry-run training step for ``num_envs`` envs: the
    reset's, then per rollout step the action noise (N, 2), the env's step
    draws and the reset draws of the NEXT_STEP merge."""
    dev = params.device
    draws = {"reset": env.draw_reset(num_envs, params, generator),
             "noise": [], "step": [], "merge_reset": []}
    for _ in range(ROLLOUT):
        draws["noise"].append(torch.randn((num_envs, 2), generator=generator, device=dev))
        draws["step"].append(env.draw_step(num_envs, params, generator))
        draws["merge_reset"].append(env.draw_reset(num_envs, params, generator))
    return draws


def train_step(venv, params, weights: dict, draws: dict, grid=None) -> tuple[float, dict]:
    """One training step of check 3 from injected ``draws`` (``step_draws``,
    for the whole batch): the reset, a ROLLOUT-step rollout of the MLP
    policy (the env stepped with the action detached), REINFORCE plus the
    prediction MSE, and the SGD step at LR. ``weights`` are the whole MLP's;
    on a ``grid`` this rank steps its data block with its model shard and
    the gradients and loss are summed over the ranks. Returns the loss and
    this rank's SGD step (``-LR * grad`` per weight)."""
    n = venv.num_envs
    local, block = venv, (lambda t: t)
    if grid is not None:
        local, block = local_venv(venv, grid.env), (lambda t: shard_env_batch(grid.env, t))
        weights = _shard_mlp(weights, grid)
    w = {k: v.clone().requires_grad_() for k, v in weights.items()}
    obs, state, _ = local.reset(params, draws=block(draws["reset"]))
    total = torch.zeros((), device=params.device)
    for t in range(ROLLOUT):
        act_mean, pred = _mlp_apply(w, _flat_obs(obs), grid)
        act = act_mean + 0.1 * block(draws["noise"][t])
        obs, state, reward, _, _, info = local.step(
            state, {"action": act.detach(), "prediction": pred}, params,
            reset_draws=block(draws["merge_reset"][t]), step_draws=block(draws["step"][t]))
        logp = -((act - act_mean) ** 2).sum(dim=-1)
        target = info["prediction"]["target"]
        if isinstance(target, dict):
            target = target["target"]
        pred_err = ((pred - target) ** 2).sum(dim=-1)
        total = total + (pred_err + (-reward).detach() * logp).sum() / n
    loss = total / ROLLOUT
    loss.backward()
    value = loss.detach()
    if grid is not None:
        grid.reduce_grads(list(w.values()))
        value = grid.data_sum(value)
    return float(value), {k: -LR * v.grad for k, v in w.items()}


def train_step_check(grid, seed: int = 0) -> dict:
    """Check 3 on this rank: the data-sharded rollout into the
    tensor-parallel MLP, its loss and SGD step (``train_step``), and the
    same step in one process (this rank, the whole batch), from the same
    draws and weights. Returns both losses and the largest |difference| of
    the sharded step from the one-process step's same columns, relative to
    that step's largest entry."""
    num_envs = 4 * grid.data
    venv, params = _make_headline(num_envs, grid.device)
    g = torch.Generator(grid.device).manual_seed(seed)
    draws = step_draws(venv.env, params, num_envs, g)
    obs, _, _ = venv.reset(params, draws=draws["reset"])
    weights = _mlp_init(g, _flat_obs(obs).shape[-1], 8 * grid.model, 2, 2, grid.device)
    loss, step = train_step(venv, params, weights, draws, grid)
    solo_loss, solo_step = train_step(venv, params, weights, draws)
    new_w = {k: w + step[k] for k, w in _shard_mlp(weights, grid).items()}
    solo_step = _shard_mlp(solo_step, grid)
    scale = max(float(v.abs().max()) for v in solo_step.values())
    diff = max(float((step[k] - solo_step[k]).abs().max()) for k in step)
    return {"loss": loss, "solo_loss": solo_loss, "num_envs": num_envs,
            "hidden": 8 * grid.model, "w1_shape": list(new_w["w1"].shape),
            "step_rel_diff": diff / scale,
            "finite": all(bool(torch.isfinite(w).all()) for w in new_w.values())}


def _rollout_checks(grid) -> dict:
    """Checks 1 and 2 on this rank: the sharded rollouts of this rank's data
    group and the one-process rollouts with generators seeded alike."""
    dev = grid.device
    num_envs = 4 * grid.data
    out = {}
    for name, (venv, params), steps, period, pred_scale, seed in (
            ("lidar", _make_headline(num_envs, dev), 6, None, 0.1, 3),
            ("episodic", _make_flagship(num_envs, dev), 10, 4, 1.0, 5)):
        if period is not None:
            params = dataclasses.replace(params, step_limit=period)

        def policy(g, obs, sharding=None, scale=pred_scale):
            full = {"action": torch.rand((num_envs, 2), generator=g, device=dev) * 2.0 - 1.0,
                    "prediction": scale * torch.randn((num_envs, 2), generator=g, device=dev)}
            return full if sharding is None else shard_env_batch(sharding, full)

        _, mean, dones = sharded_rollout(venv, grid.env, params, policy, steps, period)(
            torch.Generator(dev).manual_seed(seed))
        g = torch.Generator(dev).manual_seed(seed)
        if period is None:
            _, _, (r, te, tr) = rollout(venv, params, policy, g, steps)
        else:
            _, _, (r, te, tr) = rollout_episodic(venv, params, policy, g, steps, period)
        out[name] = {"mean_reward": float(mean), "done_count": int(dones),
                     "solo_mean_reward": float(r.double().mean()),
                     "solo_done_count": int((te | tr).sum())}
    return out


def _rank(args) -> dict:
    from .examples.train_ppo_mesh import init_rank

    grid = init_rank(args)
    try:
        out = {"rank": dist.get_rank(), "grid": [grid.data, grid.model],
               "place": [grid.d, grid.m], **_rollout_checks(grid),
               "train_step": train_step_check(grid)}
    finally:
        dist.destroy_process_group()
    for name in ("lidar", "episodic"):
        res = out[name]
        if res["done_count"] != res["solo_done_count"]:
            raise AssertionError(f"{name}: sharded done count diverged: {res}")
        if not math.isclose(res["mean_reward"], res["solo_mean_reward"], rel_tol=1e-5):
            raise AssertionError(f"{name}: sharded mean reward diverged: {res}")
    ts = out["train_step"]
    if not (math.isfinite(ts["loss"]) and ts["finite"]):
        raise AssertionError(f"non-finite training loss or weights: {ts}")
    if not math.isclose(ts["loss"], ts["solo_loss"], rel_tol=1e-5):
        raise AssertionError(f"sharded training loss {ts['loss']} != one-process "
                             f"{ts['solo_loss']}")
    if not ts["step_rel_diff"] <= 1e-5:
        raise AssertionError(f"sharded SGD step differs from the one-process step: {ts}")
    return out


def dryrun_multichip(world: int = 2, device="cuda", backend: str | None = "gloo") -> list[dict]:
    """Run the three checks on ``world`` ranks (gloo ranks may share one
    card or run on the CPU); raises if a rank fails one. Returns each
    rank's results."""
    from .examples.train_ppo_mesh import spawn_grid

    if torch.device(device).type == "cuda":
        resolve_device(device)
    outs = spawn_grid("apx_torch.graft_entry", world, str(device), backend, [])
    return [json.loads(next(ln for ln in out.splitlines() if ln.startswith("DRYRUN "))[7:])
            for out in outs]


def main(argv=None) -> None:
    from .examples.train_ppo_mesh import rank_args

    ap = rank_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    args = ap.parse_args(argv)
    if args.rank is not None or "RANK" in os.environ:
        print("DRYRUN " + json.dumps(_rank(args)), flush=True)
        return
    fn, ex = entry(args.device)
    obs, *_ = fn(*ex)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    print(f"entry OK: glimpse {tuple(obs['glimpse'].shape)}")
    dryrun_multichip(args.world or 2, args.device, args.backend or "gloo")
    print("dryrun_multichip OK")


if __name__ == "__main__":
    main()
