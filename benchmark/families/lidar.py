"""LIDARLocRooms-v0 as the benchmark builds it, draws for it, reads its
outputs and checks them.

* The maps: ``data.rooms.rooms_bank`` from the configuration's bank seed
  (its ``bank_maps`` rooms maps, the same in every run: the maps set how
  long the casts take), handed to the program as a map bank
  (``bank_from_maps``) and to the reference as they are.
* The env: ``apx_torch.make_vec(env_id, N, map_bank=...)``, NEXT_STEP
  autoreset; every step of a chunk is ``venv.step``.
* The draws of a step: the policy's action and prediction, and the reset
  draws of every env (the map's bank position and the k-th free cell); the
  initial reset's draws are made the same way and injected.
* The check: the explicit reset, and the first chunk after it, are
  followed by the reference from the draws alone. A chunk of the window is
  followed from the program's state at its start (the state carries the
  positions of every episode so far), with each env's map and dataset
  index taken from the bank by its bank position, not from the program.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.rooms import rooms_bank
from ..reference import lidar as ref
from ..yardstick.bounds import candidate_cells, lidar_step_least_s

__all__ = ["Env", "build", "draw_pool", "initial_reset", "step_chunk", "program_leaves",
           "reference_reset", "reference_chunk", "least_seconds", "OBS_KEYS"]

OBS_KEYS = ("lidar", "map", "odometry", "time_step")
STATE_KEYS = ("occ", "bank_pos", "map_idx", "pos", "initial_pos", "odo_pending", "t", "prev_done")
RESET_KEYS = ("bank_pos", "k")


@dataclasses.dataclass
class Env:
    venv: object
    params: object
    num_envs: int
    chunk: int
    bank: ref.Bank  # the maps and indices as the reference reads them
    offsets: torch.Tensor  # (B, 2) float32 beam offsets
    block: int  # envs per block of the reference


def build(config: dict, traffic: dict, seed: int, dev: torch.device) -> Env:
    import apx_torch
    from apx_torch.data.floor_map import bank_from_maps

    maps, indices = rooms_bank(config["bank_seed"], config["bank_maps"], config["map_size"],
                               config["max_rooms"], config["door_width"])
    bank = bank_from_maps(maps, indices, "rooms", dev)
    venv, params = apx_torch.make_vec(config["env_id"], traffic["num_envs"], device=dev,
                                      map_bank=bank)
    stated = (config["beams"], config["lidar_range"], config["time_limit"])
    built = (params.lidar_beam_count, params.lidar_range, venv.env.max_episode_steps)
    if built != stated:
        raise ValueError(f"the env has (beams, range, time limit) {built}, the configuration "
                         f"{stated}")
    return Env(venv=venv, params=params, num_envs=traffic["num_envs"],
               chunk=traffic["graph_steps"],
               bank=ref.Bank(torch.from_numpy(maps).to(dev), torch.from_numpy(indices).to(dev)),
               offsets=ref.beam_offsets(config["beams"], config["lidar_range"]).to(dev),
               block=traffic["check_block_envs"])


def draw_pool(env: Env, gen: torch.Generator, steps: int) -> dict:
    """The draws of ``steps`` steps, each with a leading step axis: actions
    uniform in [-1, 1), standard-normal predictions, the reset's bank
    positions uniform over the maps and k uniform over the map's free cells
    (a 62-bit draw reduced mod the count)."""
    n, dev = env.num_envs, env.offsets.device
    act = torch.rand((steps, n, 2), generator=gen, device=dev) * 2.0 - 1.0
    pred = torch.randn((steps, n, 2), generator=gen, device=dev)
    bank_pos = torch.randint(0, env.bank.maps.shape[0], (steps, n), generator=gen, device=dev)
    wide = torch.randint(0, 2**62, (steps, n), generator=gen, device=dev)
    return {"action": act, "prediction": pred, "bank_pos": bank_pos,
            "k": wide % env.bank.free_counts[bank_pos]}


def initial_reset(env: Env, gen: torch.Generator, policy):
    """(obs, state, draws) of the program's explicit reset from injected
    draws; the first chunk steps from there."""
    d = draw_pool(env, gen, 1)
    draws = {k: d[k][0] for k in RESET_KEYS}
    obs, state, _ = env.venv.reset(env.params, draws=draws)
    return obs, state, draws


def step_chunk(env: Env, obs: dict, state, draws: dict, racc: torch.Tensor,
               dacc: torch.Tensor, policy):
    """Every step of the chunk (the leading axis of ``draws``) is
    ``venv.step`` with its injected reset draws; rewards and terminations
    are added into the accumulators in place."""
    for j in range(draws["action"].shape[0]):
        full = {"action": policy(draws["action"][j], obs), "prediction": draws["prediction"][j]}
        obs, state, reward, term, *_ = env.venv.step(
            state, full, env.params, reset_draws={k: draws[k][j] for k in RESET_KEYS},
            step_draws={})
        racc.add_(reward)
        dacc.add_(term)
    return obs, state


def program_leaves(obs: dict, state) -> dict:
    """The program's outputs and carried state, by the reference's names."""
    inner = state.inner.inner
    return {**{k: obs[k] for k in OBS_KEYS},
            "occ": inner.occ, "bank_pos": inner.bank_pos, "map_idx": inner.map_idx,
            "pos": inner.pos, "initial_pos": inner.initial_pos,
            "odo_pending": inner.odo_pending, "t": state.inner.t, "prev_done": state.prev_done}


def _leaves(obs: dict, state: dict) -> dict:
    return {**obs, **{k: state[k] for k in STATE_KEYS}}


def reference_reset(env: Env, draws: dict, dtype) -> dict:
    """The reference's outputs of the explicit reset from ``draws``."""
    obs, state = ref.reset(env.bank, draws["bank_pos"], draws["k"], dtype, env.offsets)
    n = state["pos"].shape[0]
    dev = state["pos"].device
    state.update(t=torch.zeros(n, dtype=torch.int64, device=dev),
                 prev_done=torch.zeros(n, dtype=torch.bool, device=dev))
    obs.update(map=state["occ"][..., None].to(dtype) / 255.0,
               time_step=torch.full((n,), -1.0, dtype=dtype, device=dev))
    return _leaves(obs, state)


def reference_chunk(env: Env, before: dict, draws: dict, prev_draws: dict, dtype, policy,
                    record: dict | None = None) -> dict:
    """The reference's outputs after the chunk whose draws are ``draws``
    (leading step axis), from the state ``before`` at the chunk's start
    (the program's ``program_leaves``, or the reference's own reset); each
    env's map and dataset index are the bank's at its bank position. Env
    blocks of ``env.block`` step together, since the policy reads env 0's
    observation. With ``record``, the first step's casts' candidate cells
    go to ``record["cells"]``."""
    n = before["pos"].shape[0]
    blocks = [slice(i, min(i + env.block, n)) for i in range(0, n, env.block)]
    states = []
    for b in blocks:
        bank_pos = before["bank_pos"][b].to(torch.int64)
        s = {k: before[k][b].to(dtype) if before[k].is_floating_point()
             else before[k][b].to(torch.int64) if k == "t" else before[k][b]
             for k in STATE_KEYS}
        s.update(bank_pos=bank_pos, occ=env.bank.maps[bank_pos],
                 map_idx=env.bank.indices[bank_pos])
        states.append(s)
    obs = [{k: before[k][b] for k in OBS_KEYS} for b in blocks]
    rsum = [torch.zeros(b.stop - b.start, dtype=dtype, device=before["pos"].device)
            for b in blocks]
    tcount = [torch.zeros_like(r, dtype=torch.int64) for r in rsum]
    h, w = env.bank.maps.shape[1:]
    for j in range(draws["action"].shape[0]):
        act = policy(draws["action"][j], obs[0])
        for i, b in enumerate(blocks):
            casts = [] if record is not None and j == 0 else None
            obs[i], states[i], reward, term, _ = ref.vector_step(
                states[i], act[b], draws["prediction"][j][b], env.bank, draws["bank_pos"][j][b],
                draws["k"][j][b], env.offsets, casts)
            rsum[i] += reward
            tcount[i] += term
            if casts:
                record["cells"] = record.get("cells", 0) + sum(
                    candidate_cells(h, w, o, t) for o, t in casts)
    out = {k: torch.cat([_leaves(o, s)[k] for o, s in zip(obs, states)])
           for k in _leaves(obs[0], states[0])}
    out["reward_sum"] = torch.cat(rsum)
    out["term_count"] = torch.cat(tcount)
    return out


def least_seconds(env: Env, record: dict) -> dict:
    """Least seconds per vector step of the LIDAR step function (the three
    casts and the arithmetic around them) at this cell's shapes, its casts'
    cells taken from the first step of a checked chunk."""
    if "cells" not in record:
        return {}
    h, w = env.bank.maps.shape[1:]
    return {"lidar_step": lidar_step_least_s(env.num_envs, h, w, env.offsets.shape[0],
                                             record["cells"])}
