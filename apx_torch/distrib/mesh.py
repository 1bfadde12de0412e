"""Env-batch data parallelism over ``torch.distributed`` (counterpart of
apx.distrib.mesh).

The reference's only parallelism is an env batch stepped in one call;
apx shards that batch over a 1-D device mesh (axis "env"). Here one
process drives one device, and rank r of W holds the contiguous block
``[r N/W, (r+1) N/W)`` of the global batch of N envs: the layout of
``P("env")`` on a 1-D mesh. Every env's dynamics are independent, so
stepping inserts ZERO collectives: each rank steps its block, accumulates
its reward sum and done count on its device, and ``sharded_rollout`` ends
on one ``all_reduce``. Params (map and image banks) are replicated: rank 0
broadcasts them (``shard_params``).

**The draw contract** (the counterpart of threefry being partitionable).
Every rank's generator is seeded alike and draws the GLOBAL batch's
draws, in the order ``rollout`` / ``rollout_episodic`` draw them: the
reset draws ``env.draw_reset(N, ...)``, then per step the policy's
(``policy_fn(generator, obs_local, sharding)`` draws (N, ...) and returns
``sharding.local(...)``), the step draws and the reset draws. The rank
keeps its block and injects it (``reset(draws=)``, ``step(reset_draws=,
step_draws=)``), so its trajectory is bitwise the block of the one-process
run with the same seed, on the CPU and on the card. The cost: every rank
makes the whole batch's draws, a few (N,) tensors per step, W times over
across ranks.

Only ``all_reduce`` and ``broadcast`` are used: gloo runs both on CUDA
tensors, which is how two ranks share one card (NCCL refuses two ranks on
one GPU).

    init_distributed(init_method="file:///tmp/store", rank=r, world_size=W)
    sharding = make_env_mesh("cuda")
    params = shard_params(sharding, params)
    run = sharded_rollout(venv, sharding, params, policy_fn, num_steps)
    final_local_state, mean_reward, done_count = run(generator)
"""

from __future__ import annotations

import dataclasses
import enum
import os
import types
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..core.env import AutoResetMode, tree_map, with_autoreset

__all__ = [
    "EnvSharding",
    "init_distributed",
    "make_env_mesh",
    "shard_env_batch",
    "shard_params",
    "sharded_vector_env_step",
    "sharded_rollout",
]


def init_distributed(backend: str | None = None, device="cuda", **kwargs) -> None:
    """``torch.distributed.init_process_group`` (idempotent). ``backend``
    defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU;
    ``kwargs`` go to ``init_process_group`` (``init_method``, ``rank``,
    ``world_size``, ``store``, ``timeout``; none under ``torchrun``, which
    sets the environment)."""
    if dist.is_initialized():
        return  # idempotent: a second call is a no-op
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    try:
        dist.init_process_group(backend=backend, **kwargs)
    except (RuntimeError, ValueError):
        # A raced double initialization is still idempotent; anything else
        # (no NCCL, no rendezvous) must propagate, or the process would go
        # on as a one-rank run of its own. State is queried rather than
        # matching the error text.
        if dist.is_initialized():
            return
        raise


@dataclasses.dataclass(frozen=True)
class EnvSharding:
    """This rank's place in the env axis: rank ``rank`` of ``world_size``
    in ``group`` (None: the default group), stepping on ``device``."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a global batch of ``n``."""
        if n % self.world_size:
            raise ValueError(f"a batch of {n} envs does not split evenly over "
                             f"{self.world_size} ranks")
        size = n // self.world_size
        return slice(self.rank * size, (self.rank + 1) * size)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global (N, ...) tensor."""
        return x[self.block(x.shape[0])]


def make_env_mesh(device="cuda", group=None) -> EnvSharding:
    """The calling rank's ``EnvSharding`` in ``group`` of the initialized
    process group. A CUDA ``device`` without an index is ``cuda:LOCAL_RANK``
    (set by ``torchrun``), else the current device; it becomes the current
    device. A CUDA device that is not there raises: the env batch never
    falls back to the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed() before make_env_mesh()")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_env_mesh was asked for a CUDA device and none is "
                               "available; pass device='cpu' to shard on the CPU")
        if device.index is None:
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())))
        torch.cuda.set_device(device)
    return EnvSharding(rank=dist.get_rank(group), world_size=dist.get_world_size(group),
                       device=device, group=group)


def shard_env_batch(sharding: EnvSharding, tree: Any) -> Any:
    """This rank's block of every leaf's leading (env) axis."""
    return tree_map(sharding.local, tree)


def _tensors(tree, seen: set) -> list[torch.Tensor]:
    """The distinct tensors reachable from ``tree`` through dataclass
    fields, dicts, tuples, lists and plain objects' attributes, in a
    deterministic order."""
    if id(tree) in seen or tree is None or isinstance(tree, (str, bytes, int, float, bool)):
        return []
    seen.add(id(tree))
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        children = list(tree.values())
    elif isinstance(tree, (tuple, list)):
        children = list(tree)
    elif dataclasses.is_dataclass(tree):
        children = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif hasattr(tree, "__dict__") and not isinstance(
            tree, (type, enum.Enum, types.FunctionType, types.ModuleType)):
        children = list(vars(tree).values())
    else:
        return []
    return [t for c in children for t in _tensors(c, seen)]


def shard_params(sharding: EnvSharding, params: Any, shard_leading: bool = False):
    """Replicate ``params``: rank 0 broadcasts every tensor in them (the
    map and image banks included), in place, so every rank holds a
    bitwise-identical copy on its own device. Returns ``params``."""
    if shard_leading:
        raise NotImplementedError(
            "shard_params(shard_leading=True), a bank sharded across ranks with fetches "
            "by collective, is not ported yet (ROADMAP queue 1)")
    src = 0 if sharding.group is None else dist.get_global_rank(sharding.group, 0)
    for t in _tensors(params, set()):
        if t.device != sharding.device or not t.is_contiguous():
            raise ValueError(f"params tensor of shape {tuple(t.shape)} on {t.device} "
                             f"(contiguous: {t.is_contiguous()}) cannot be broadcast on "
                             f"{sharding.device}")
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=src,
                       group=sharding.group)
    return params


def _with_num_envs(venv, n: int):
    """``venv`` stepping ``n`` envs, through vector-level wrappers that hold
    the vector env in a ``venv`` field (as ``with_autoreset`` recurses)."""
    if any(f.name == "num_envs" for f in dataclasses.fields(venv)):
        return dataclasses.replace(venv, num_envs=n)
    if hasattr(venv, "venv"):
        return dataclasses.replace(venv, venv=_with_num_envs(venv.venv, n))
    raise TypeError(f"cannot set num_envs on {type(venv).__name__}")


def _local_venv(venv, sharding: EnvSharding):
    block = sharding.block(venv.num_envs)
    return _with_num_envs(venv, block.stop - block.start)


def sharded_vector_env_step(venv, sharding: EnvSharding) -> Callable:
    """``step(state, full_action, params, generator)`` of this rank's block:
    draws the global batch's step and reset draws from ``generator`` as
    ``venv.step`` draws them, keeps the block's and steps the block. It
    inserts no collective."""
    n, env = venv.num_envs, venv.env
    local = _local_venv(venv, sharding)
    disabled = local.autoreset is AutoResetMode.DISABLED

    def step(state, full_action, params, generator: torch.Generator):
        step_draws = shard_env_batch(sharding, env.draw_step(n, params, generator))
        reset_draws = None if disabled else shard_env_batch(
            sharding, env.draw_reset(n, params, generator))
        return local.step(state, full_action, params, reset_draws=reset_draws,
                          step_draws=step_draws)

    return step


def sharded_rollout(
    venv,
    sharding: EnvSharding,
    params,
    policy_fn: Callable[[torch.Generator, Any, EnvSharding], dict[str, Any]],
    num_steps: int,
    episodic_period: int | None = None,
):
    """Returns ``run(generator) -> (final_local_state, mean_reward,
    done_count)``: a rollout of this rank's block of ``venv``'s N envs,
    bitwise the block of ``rollout`` (or, with ``episodic_period``, of
    ``rollout_episodic``: the LOCKSTEP boundary hoisted out of the step)
    with a generator seeded alike. ``mean_reward`` (float64) and
    ``done_count`` (int64) are over all ranks, envs and steps, reduced by
    one ``all_reduce`` after the last step; no collective runs inside the
    step loop."""
    n, env = venv.num_envs, venv.env
    local = _local_venv(venv, sharding)
    if episodic_period is not None:
        if venv.autoreset is not AutoResetMode.LOCKSTEP:
            raise ValueError("episodic_period needs a LOCKSTEP vector env")
        inner = with_autoreset(local, AutoResetMode.DISABLED)
    else:
        step = sharded_vector_env_step(venv, sharding)

    def run(generator: torch.Generator):
        obs, state, _ = local.reset(
            params, draws=shard_env_batch(sharding, env.draw_reset(n, params, generator)))
        reward_sum = torch.zeros((), dtype=torch.float64, device=sharding.device)
        done_count = torch.zeros((), dtype=torch.int64, device=sharding.device)
        for i in range(num_steps):
            act = policy_fn(generator, obs, sharding)
            if episodic_period is None:
                obs, state, reward, term, trunc, _ = step(state, act, params, generator)
            else:
                step_draws = shard_env_batch(sharding, env.draw_step(n, params, generator))
                reset_draws = shard_env_batch(sharding, env.draw_reset(n, params, generator))
                if i % (episodic_period + 1) == episodic_period:
                    obs, state, reward, term, trunc, _ = local.boundary_reset_step(
                        state, act, params, reset_draws=reset_draws, step_draws=step_draws)
                else:
                    obs, state, reward, term, trunc, _ = inner.step(
                        state, act, params, step_draws=step_draws)
            reward_sum += reward.sum(dtype=torch.float64)
            done_count += (term | trunc).sum()
        total = torch.stack([reward_sum, done_count.to(torch.float64)])
        dist.all_reduce(total, group=sharding.group)  # the rollout's one collective
        return state, total[0] / (n * num_steps), total[1].to(torch.int64)

    return run
