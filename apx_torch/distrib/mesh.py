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
broadcasts them (``shard_params``). With ``shard_leading=True`` each rank
keeps only its block [rM/W, (r+1)M/W) of every bank leaf with a leading
bank axis (apx's ``P("env")`` placement of the banks), received block by
block from rank 0, and a bank fetch becomes a collective
(``BankShard.take``). Built on the CPU, the bank never reaches the card
whole.

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

**The sharded bank's fetch.** Every rank steps the same code on blocks of
one size, so every rank reaches each bank fetch together, with its own
block's indices. A fetch is two ``all_reduce(SUM)``: the first shares the
requests (each rank writes its (n,) indices into its row of a (W, n)
zero buffer), the second the rows: each rank fills, for every request of
every rank, the rows it owns and zeros elsewhere, all leaves of the fetch
packed as bytes into one int64 buffer. The owners are disjoint, so the
sum is each row exactly, whatever its type. ``COLLECTIVE_BYTES`` counts
the bytes the fetches move.

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
    "BankShard",
    "COLLECTIVE_BYTES",
    "EnvSharding",
    "init_distributed",
    "local_venv",
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


# Bytes moved by the sharded banks' fetches in this process (both
# all_reduce buffers of each fetch), for measurements.
COLLECTIVE_BYTES = {"bank_fetch": 0}


@dataclasses.dataclass(frozen=True)
class BankShard:
    """This rank's block [lo, hi) of a bank of ``num_rows`` rows."""

    sharding: EnvSharding
    num_rows: int

    def __post_init__(self):
        if self.num_rows % self.sharding.world_size:
            raise ValueError(f"a bank of {self.num_rows} rows does not split evenly over "
                             f"{self.sharding.world_size} ranks")

    @property
    def lo(self) -> int:
        return self.sharding.rank * self.num_rows // self.sharding.world_size

    @property
    def hi(self) -> int:
        return (self.sharding.rank + 1) * self.num_rows // self.sharding.world_size

    def take(self, idx: torch.Tensor, leaves: list[tuple[torch.Tensor, Any]]) -> list[torch.Tensor]:
        """``leaf[idx]`` (or ``leaf[idx, col]``) for each (leaf, col) pair,
        where each leaf is this rank's block and ``idx`` (n,) this rank's
        requests of global rows: the collective fetch of the module
        docstring. Every rank calls it together with the same n and leaves."""
        sh = self.sharding
        w, r, n = sh.world_size, sh.rank, idx.shape[0]
        dev = idx.device
        cols = [c for _, c in leaves if c is not None]
        req = torch.zeros((w, 1 + len(cols), n), dtype=torch.int64, device=dev)
        req[r, 0] = idx
        for i, c in enumerate(cols):
            req[r, 1 + i] = c
        dist.all_reduce(req, group=sh.group)
        rows = req[:, 0]  # (W, n) every rank's requests
        own = (rows >= self.lo) & (rows < self.hi)
        local = (rows - self.lo).clamp(0, self.hi - self.lo - 1)
        parts, shapes, ci = [], [], 1
        for leaf, col in leaves:
            v = leaf[local] if col is None else leaf[local, req[:, ci]]
            ci += col is not None
            mask = own.reshape(w, n, *([1] * (v.ndim - 2)))
            v = torch.where(mask, v, torch.zeros((), dtype=v.dtype, device=dev))
            shapes.append((v.dtype, v.shape[2:]))
            parts.append(v.reshape(w, n, -1).contiguous().view(torch.uint8))
        sizes = [p.shape[-1] for p in parts]
        pad = -sum(sizes) % 8
        buf = torch.cat(parts + [torch.zeros((w, n, pad), dtype=torch.uint8, device=dev)], -1)
        buf = buf.view(torch.int64)
        dist.all_reduce(buf, group=sh.group)
        COLLECTIVE_BYTES["bank_fetch"] += req.numel() * 8 + buf.numel() * 8
        mine = buf[r].view(torch.uint8)  # (n, bytes) this rank's rows
        out, at = [], 0
        for (dtype, tail), size in zip(shapes, sizes):
            out.append(mine[:, at:at + size].contiguous().view(dtype).reshape(n, *tail))
            at += size
        return out


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
    bitwise-identical copy on its own device. Returns ``params``.

    With ``shard_leading``, returns a copy of them whose banks
    (``MapBank``, ``BankImageDataset``) keep only this rank's block of
    their leading axis, fetched by collective (``BankShard``); the bank's
    rows must split evenly over the ranks. The banks are not broadcast
    whole: rank 0 sends its rows one block at a time, and each rank keeps
    its own block, a copy on its device. A bank may lie on the CPU
    (``make_vec(..., device="cpu")``, the bank is all that lies on a
    device in the params): then the whole bank never reaches the card, and
    only the block is allocated there. Other tensors are broadcast in
    place, as replicated."""
    src = 0 if sharding.group is None else dist.get_global_rank(sharding.group, 0)
    banks = _banks(params) if shard_leading else []
    in_banks = {id(t) for b in banks for t in _tensors(b, set())}
    for t in _tensors(params, set()):
        if id(t) in in_banks:
            continue
        if t.device != sharding.device or not t.is_contiguous():
            raise ValueError(f"params tensor of shape {tuple(t.shape)} on {t.device} "
                             f"(contiguous: {t.is_contiguous()}) cannot be broadcast on "
                             f"{sharding.device}")
        _broadcast(t, src, sharding)
    if not shard_leading:
        return params
    placed = {}
    for bank in banks:
        rows = bank.num_maps if hasattr(bank, "num_maps") else bank.length
        shard = BankShard(sharding, rows)
        placed[id(bank)] = bank.sharded(shard, block=lambda leaf, s=shard: _block(leaf, s, src),
                                        whole=lambda leaf: _whole(leaf, sharding, src))
    return _replace_banks(params, placed)


def _broadcast(t: torch.Tensor, src: int, sharding: EnvSharding) -> torch.Tensor:
    dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=src,
                   group=sharding.group)
    return t


def _block(leaf: torch.Tensor, shard: BankShard, src: int) -> torch.Tensor:
    """Rank 0's rows [shard.lo, shard.hi) of a bank leaf, on this rank's
    device: one broadcast of a block-sized buffer per rank's block."""
    sh = shard.sharding
    size = shard.hi - shard.lo
    mine = None
    for q in range(sh.world_size):
        if sh.rank == 0:
            buf = leaf[q * size:(q + 1) * size].to(sh.device, copy=True).contiguous()
        else:
            buf = torch.empty((size, *leaf.shape[1:]), dtype=leaf.dtype, device=sh.device)
        _broadcast(buf, src, sh)
        if q == sh.rank:
            mine = buf
    return mine


def _whole(leaf: torch.Tensor, sharding: EnvSharding, src: int) -> torch.Tensor:
    """Rank 0's whole ``leaf`` on this rank's device (a bank leaf without
    a bank axis: the beam tables)."""
    return _broadcast(leaf.to(sharding.device).contiguous(), src, sharding)


def _banks(tree, seen: set | None = None) -> list:
    """The distinct banks (objects with ``sharded`` and ``shard``) in
    ``tree``, through dataclass fields."""
    seen = set() if seen is None else seen
    if id(tree) in seen:
        return []
    seen.add(id(tree))
    if hasattr(tree, "sharded") and hasattr(tree, "shard"):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [b for f in dataclasses.fields(tree) if f.init
                for b in _banks(getattr(tree, f.name), seen)]
    return []


def _replace_banks(tree, placed: dict):
    """``tree`` with every bank replaced by ``placed[id(bank)]``, through
    dataclass fields."""
    if id(tree) in placed:
        return placed[id(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {f.name: _replace_banks(getattr(tree, f.name), placed)
                   for f in dataclasses.fields(tree) if f.init}
        changes = {k: v for k, v in changes.items() if v is not getattr(tree, k)}
        return dataclasses.replace(tree, **changes) if changes else tree
    return tree


def _with_num_envs(venv, n: int):
    """``venv`` stepping ``n`` envs, through vector-level wrappers that hold
    the vector env in a ``venv`` field (as ``with_autoreset`` recurses)."""
    if any(f.name == "num_envs" for f in dataclasses.fields(venv)):
        return dataclasses.replace(venv, num_envs=n)
    if hasattr(venv, "venv"):
        return dataclasses.replace(venv, venv=_with_num_envs(venv.venv, n))
    raise TypeError(f"cannot set num_envs on {type(venv).__name__}")


def local_venv(venv, sharding: EnvSharding):
    """``venv`` stepping only this rank's block of its envs."""
    block = sharding.block(venv.num_envs)
    return _with_num_envs(venv, block.stop - block.start)


def sharded_vector_env_step(venv, sharding: EnvSharding) -> Callable:
    """``step(state, full_action, params, generator)`` of this rank's block:
    draws the global batch's step and reset draws from ``generator`` as
    ``venv.step`` draws them, keeps the block's and steps the block. It
    inserts no collective."""
    n, env = venv.num_envs, venv.env
    local = local_venv(venv, sharding)
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
    local = local_venv(venv, sharding)
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
