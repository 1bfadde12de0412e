"""One rank of the training recipes on a (data, model) grid, each checked
against its one-process run.

    python -m apx_torch.examples.grid_selftest --rank R --world W --init file:///tmp/s \\
        --device cpu [--backend gloo] [--num-envs 16] [--rollout-len 4] \\
        [--recipes ppo,vtrace,r2d2]

Every rank runs, in order, the recipes named:

* ``ppo``: ``train_ppo_mesh.ppo_check``, one PPO iteration on the grid
  and the same iteration in one process: both mean rewards, the largest
  |difference| of this rank's ``trunk.w`` rows from the one-process net's;
* ``vtrace``: ``train_vtrace_mesh.vtrace_check``, two iterations with
  ``sync_every=2``: the rewards, and whether the behavior net equals the
  learner bitwise after them;
* ``r2d2``: ``train_r2d2_mesh.r2d2_check``, two iterations (hidden 32,
  seq_len 6, burn-in 2, capacity 4, target sync every 2): the ring's
  ``ptr`` and ``filled``, whether the target net equals the online one;

each of the two also in one process: its rewards and the largest
|difference| of this rank's ``trunk.w`` rows from the one-process net's.

and prints one line, ``GRIDTEST {json}``, with its rank, its place in the
grid and each recipe's result. The caller holds them to their bounds.
Products and convolutions run in full float32 (TF32 off on a card), so
that the grid's sums and the one-process run's differ in order only.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from ..core.numerics import matmul_tf32
from .train_ppo_mesh import init_rank, ppo_check, rank_args
from .train_r2d2_mesh import r2d2_check
from .train_vtrace_mesh import vtrace_check


def main(argv=None) -> dict:
    ap = rank_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--num-envs", type=int, default=16)
    ap.add_argument("--rollout-len", type=int, default=4)
    ap.add_argument("--num-minibatches", type=int, default=2)
    ap.add_argument("--recipes", default="ppo,vtrace,r2d2")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    grid = init_rank(args)
    out = {"rank": dist.get_rank(), "grid": [grid.data, grid.model], "place": [grid.d, grid.m],
           "device": str(grid.device), "backend": dist.get_backend()}
    try:
        with matmul_tf32(False):
            _run_recipes(grid, args, out)
    finally:
        dist.destroy_process_group()
    print("GRIDTEST " + json.dumps(out), flush=True)
    return out


def _run_recipes(grid, args, out: dict) -> None:
    for recipe in args.recipes.split(","):
        if recipe == "ppo":
            out["ppo"] = ppo_check(grid, args.num_envs, args.rollout_len, args.num_minibatches)
        elif recipe == "vtrace":
            out["vtrace"] = vtrace_check(grid, args.num_envs, args.rollout_len, solo=True)
        elif recipe == "r2d2":
            out["r2d2"] = r2d2_check(grid, args.num_envs, solo=True)
        else:
            raise ValueError(f"unknown recipe {recipe!r}")

if __name__ == "__main__":
    main()
