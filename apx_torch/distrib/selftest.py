"""One rank of a sharded rollout, checked against the one-process run.

    python -m apx_torch.distrib.selftest --rank R --world W --init file:///tmp/store \\
        --device cuda:0 [--backend gloo|nccl] --env LIDARLocRooms-v0 \\
        --num-envs 4096 --steps 250 [--episodic-period 16] [--seed 0] [--shard-bank]

Every rank builds ``make_vec(env, N)``, replicates its params from rank 0
(``shard_params``) and runs ``sharded_rollout`` on its block with the
random policy below (uniform actions in [-1, 1], standard-normal
predictions, drawn for the whole batch), its launch counts set to 0 just
before the rollout and read just after. Rank 0 then runs the
one-process ``rollout`` (or ``rollout_episodic``) of all N envs from a
generator seeded alike. Each rank prints one line, ``SELFTEST {json}``:
its block, the sha256 digest of its block's final state, the global mean
reward and done count, its kernel launches and seconds; rank 0 adds
``solo``: the digest of each rank's block of the one-process final state,
its mean reward (float64 over all envs and steps), done count, launches
and seconds. The caller holds each rank's digest to the solo digest of
its block, the done counts equal and the mean rewards close.

``--shard-bank`` shards the bank instead of replicating it
(``shard_params(..., shard_leading=True)`` of params built on the CPU, so
only the block reaches the device): each rank's line adds ``bank``, the
rows it holds, the rows of each bank leaf it holds and their digest, the
bytes of the block's leaves, of the storage behind them and of the whole
bank, the device memory the sharding allocated (``memory_allocated``
before and after, None on the CPU), and the bytes per step its collective
fetches moved; rank 0's ``solo`` adds ``bank_digests``, the digest of each
rank's block of the whole bank. The solo run uses the whole (replicated)
bank.

Without ``--init`` the rendezvous comes from the environment
(``torchrun``). ``--backend`` defaults to nccl on a CUDA device and gloo
on the CPU; two ranks on one card need gloo.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import torch
import torch.distributed as dist

from ..core.env import AutoResetMode, rollout, rollout_episodic, tree_map
from ..ops._launch import clear_launches, launches
from ..registry import make_vec
from .mesh import (COLLECTIVE_BYTES, EnvSharding, init_distributed, make_env_mesh,
                   shard_env_batch, shard_params, sharded_rollout)

__all__ = ["random_policy", "state_digest", "main"]


def _launches() -> dict[str, int]:
    """The entries launched since the last ``clear_launches()``, by key."""
    return {k: v for k, v in launches().items() if v}


def random_policy(venv, params):
    """``policy(generator, obs, sharding=None)``: uniform actions in [-1, 1]
    and standard-normal predictions for all of ``venv``'s envs, drawn on
    the params' device; with a ``sharding``, its block of them."""
    n, dev = venv.num_envs, params.device
    act_shape = venv.env.inner_action_space(params).shape
    pred_shape = venv.env.prediction_space(params).shape

    def policy(generator, obs, sharding: EnvSharding | None = None):
        full = {
            "action": torch.rand((n, *act_shape), generator=generator, device=dev) * 2.0 - 1.0,
            "prediction": torch.randn((n, *pred_shape), generator=generator, device=dev),
        }
        return full if sharding is None else shard_env_batch(sharding, full)

    return policy


def state_digest(tree) -> str:
    """sha256 over a tree's tensor leaves in tree order: dtype, shape and
    bytes of each."""
    h = hashlib.sha256()

    def add(x: torch.Tensor):
        h.update(f"{x.dtype}{tuple(x.shape)}".encode())
        h.update(x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())

    tree_map(add, tree)
    return h.hexdigest()


def bank_of(params):
    """The bank in ``params``: a map bank or an image dataset."""
    return getattr(params, "map_bank", None) or params.dataset


def bank_leaves(bank) -> dict[str, torch.Tensor]:
    """The leaves with a leading bank axis of a map or image bank."""
    names = (("maps", "indices", "free_counts", "row_words", "free_cells")
             if hasattr(bank, "row_words") else ("images", "labels"))
    return {k: getattr(bank, k) for k in names}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args) -> dict:
    init_distributed(backend=args.backend, device=args.device,
                     **({} if args.init is None else {"init_method": args.init, "rank": args.rank,
                                                      "world_size": args.world}))
    try:
        sharding = make_env_mesh(args.device)
        dev = sharding.device
        venv, params = make_vec(args.env, args.num_envs, device=dev)
        params = shard_params(sharding, params)  # replicated: the solo run's
        run_params, added = params, None
        if args.shard_bank:
            host_params = make_vec(args.env, args.num_envs, device="cpu")[1]
            _sync(dev)
            before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
            run_params = shard_params(sharding, host_params, shard_leading=True)
            _sync(dev)
            if before is not None:
                added = torch.cuda.memory_allocated(dev) - before
            del host_params
        if args.episodic_period is not None and venv.autoreset is not AutoResetMode.LOCKSTEP:
            raise ValueError(f"--episodic-period needs a LOCKSTEP id; {args.env} is not")
        policy = random_policy(venv, params)
        go = sharded_rollout(venv, sharding, run_params, policy, args.steps, args.episodic_period)

        _sync(dev)
        clear_launches()
        moved = COLLECTIVE_BYTES["bank_fetch"]
        t0 = time.perf_counter()
        state, mean_reward, done_count = go(torch.Generator(dev).manual_seed(args.seed))
        _sync(dev)
        seconds = time.perf_counter() - t0
        block = sharding.block(args.num_envs)
        out = {"rank": sharding.rank, "world_size": sharding.world_size,
               "backend": dist.get_backend(), "device": str(dev),
               "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "env": args.env, "num_envs": args.num_envs, "block": [block.start, block.stop],
               "steps": args.steps, "episodic_period": args.episodic_period,
               "digest": state_digest(state), "mean_reward": float(mean_reward),
               "done_count": int(done_count), "launches": _launches(), "seconds": seconds}
        if args.shard_bank:
            bank = bank_of(run_params)
            leaves = bank_leaves(bank)
            out["bank"] = {"rows": [bank.shard.lo, bank.shard.hi], "num_rows": bank.shard.num_rows,
                           "leaf_rows": {k: int(v.shape[0]) for k, v in leaves.items()},
                           "digest": state_digest(leaves),
                           "leaf_bytes": sum(v.nbytes for v in leaves.values()),
                           "storage_bytes": sum(v.untyped_storage().nbytes()
                                                for v in leaves.values()),
                           "whole_bank_bytes": sum(v.nbytes
                                                   for v in bank_leaves(bank_of(params)).values()),
                           "device_bytes_added": added,
                           "bytes_per_step": (COLLECTIVE_BYTES["bank_fetch"] - moved) / args.steps}
    finally:
        dist.destroy_process_group()

    if sharding.rank == 0:
        g = torch.Generator(dev).manual_seed(args.seed)
        _sync(dev)
        clear_launches()
        t0 = time.perf_counter()
        if args.episodic_period is None:
            _, state, (rewards, terms, truncs) = rollout(venv, params, policy, g, args.steps)
        else:
            _, state, (rewards, terms, truncs) = rollout_episodic(
                venv, params, policy, g, args.steps, args.episodic_period)
        _sync(dev)
        out["solo"] = {
            "digests": [state_digest(shard_env_batch(EnvSharding(r, sharding.world_size, dev),
                                                     state))
                        for r in range(sharding.world_size)],
            "mean_reward": float(rewards.to(torch.float64).mean()),
            "done_count": int((terms | truncs).sum()),
            "launches": _launches(), "seconds": time.perf_counter() - t0}
        if args.shard_bank:
            leaves = bank_leaves(bank_of(params))
            size = next(iter(leaves.values())).shape[0] // sharding.world_size
            out["solo"]["bank_digests"] = [
                state_digest({k: v[r * size:(r + 1) * size] for k, v in leaves.items()})
                for r in range(sharding.world_size)]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--init", default=None, help="init_method URL (file://...); "
                    "default: the environment, as torchrun sets it")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--env", default="LIDARLocRooms-v0")
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--episodic-period", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard-bank", action="store_true",
                    help="shard the bank across the ranks (shard_leading=True)")
    args = ap.parse_args(argv)
    if args.init is not None and (args.rank is None or args.world is None):
        ap.error("--init needs --rank and --world")
    print("SELFTEST " + json.dumps(run(args)), flush=True)


if __name__ == "__main__":
    main()
