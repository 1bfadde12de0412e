"""Mesh-sharded PPO: data-parallel env axis x tensor-parallel learner (the
twin of apx's ``examples/train_ppo_mesh.py``).

The same PPO as ``train_ppo_lidar`` (the iteration is literally its
``make_train_iter``, given a ``grid``), on a (data, model) grid of
``torch.distributed`` ranks, one process each:

* ``data``: the env batch. Rank (d, m) steps the contiguous block d of the
  N envs (``EnvSharding`` of the data group), with no collective in the
  step. Every rank draws the whole batch's draws from a generator seeded
  alike and keeps its block, so the trajectories are the one-process
  run's. The net and the optimizer are replicated over ``data``: the
  gradients are summed over the data group after each backward, the
  means (the prediction loss, the advantage statistics, the reward) are
  over the whole batch, and the rollout is gathered over the data group
  once per iteration, so that every minibatch holds the rows of the
  one-process run's, each data rank taking its share of them.
* ``model``: the learner's hidden dimension, Megatron's 1-D tensor
  parallelism: ``prop`` and ``map_proj`` are column-parallel (their output
  columns and biases split), ``trunk`` row-parallel (its input rows split
  to match the local activations: the r-th block of the ``prop`` half and
  the r-th block of the ``map_proj`` half), its partial products summed
  over ``model`` (g), the encoder's gradient summed into the
  column-parallel layers' input (f). Heads and the convolutions are
  replicated.

apx's GSPMD inserts these collectives itself; here they are the explicit
pair of ``torch.autograd.Function``s below and the data-axis sums. Every
collective is an ``all_reduce`` (the gather packs each rank's bytes into its
own slot of a zero buffer), which gloo runs on CUDA tensors too: that is
how several ranks share one card.

    python -m apx_torch.examples.train_ppo_mesh [num_envs] [iterations]

spawns one rank per card over nccl (two or more cards), else four gloo
ranks on ``cuda:0`` (a 2 x 2 grid); ``--world W --device cpu`` runs W gloo
ranks on the CPU. Under ``torchrun`` each process is one rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from ..core.env import tree_map
from ..distrib.mesh import EnvSharding, init_distributed, local_venv, shard_env_batch
from ..registry import _device as resolve_device
from ..registry import make_vec
from .train_ppo_lidar import ClipAdam, init_net, make_train_iter

__all__ = ["Grid", "make_dp_tp_grid", "shard_net", "trunk_rows", "trunk_diff", "trunk_grad_diff",
           "trunk_worst_grad", "spawn_grid", "rank_args", "init_rank", "launch", "report",
           "ppo_check", "main"]

ROOT = Path(__file__).resolve().parents[2]
SPAWN_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place (d, m) in a (data, model) grid, its groups and
    device, and ``env``: its ``EnvSharding`` in the data group."""

    data: int
    model: int
    d: int
    m: int
    device: torch.device
    data_group: Any
    model_group: Any
    env: EnvSharding

    def _sum(self, x: torch.Tensor, size: int, group) -> torch.Tensor:
        if size == 1:
            return x
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._sum(x, self.data, self.data_group)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._sum(x, self.model, self.model_group)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: identity forward, gradient summed over ``model``."""
        return x if self.model == 1 else _CopyToModel.apply(x, self)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g: summed over ``model`` forward, identity backward."""
        return x if self.model == 1 else _ReduceFromModel.apply(x, self)

    def reduce_grads(self, params: list[torch.Tensor]) -> None:
        """Sum every gradient over the data group, in one collective."""
        if self.data == 1:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=self.data_group)
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p))
            at += p.numel()

    def sq_norm(self, params: list[torch.Tensor]) -> torch.Tensor:
        """The squared global norm of the gradients of the whole net: the
        replicated leaves' squares here, the sharded leaves' summed over
        ``model``."""
        rep = sum(torch.sum(p.grad * p.grad) for p in params if not _sharded(p))
        shard = sum(torch.sum(p.grad * p.grad) for p in params if _sharded(p))
        return rep + self.model_sum(torch.as_tensor(shard, device=self.device))

    def gather_envs(self, tree):
        """Every leaf (T, n, ...) of this rank's block -> (T, D n, ...) of
        the whole batch, in block order: one ``all_reduce`` of the leaves'
        bytes, each rank's in its own slot of a zero buffer (exact for any
        dtype)."""
        if self.data == 1:
            return tree
        leaves = []
        tree_map(leaves.append, tree)
        parts = [x.contiguous().view(torch.uint8).reshape(-1) for x in leaves]
        size = sum(p.numel() for p in parts)
        words = -(-size // 8)
        buf = torch.zeros((self.data, words * 8), dtype=torch.uint8, device=self.device)
        buf[self.d, :size] = torch.cat(parts)
        buf = buf.view(torch.int64)
        dist.all_reduce(buf, group=self.data_group)
        rows = buf.view(torch.uint8)
        whole, at = [], 0
        for x in leaves:
            nbytes = x.numel() * x.element_size()
            blocks = [rows[q, at:at + nbytes].view(x.dtype).reshape(x.shape)
                      for q in range(self.data)]
            whole.append(torch.cat(blocks, dim=1))
            at += nbytes
        it = iter(whole)
        return tree_map(lambda _: next(it), tree)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.model_sum(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        return grid.model_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sharded(p: torch.Tensor) -> bool:
    return getattr(p, "tp_sharded", False)


def make_dp_tp_grid(device="cuda") -> Grid:
    """The (data, model) grid of the initialized process group (apx's
    ``make_dp_tp_mesh``): the world donates a factor of 2 to ``model`` when
    it is even, the rest is ``data``; rank r is (r // model, r % model).
    Every rank builds every data and model group, in one order. A CUDA
    ``device`` without an index is ``cuda:LOCAL_RANK``."""
    world, rank = dist.get_world_size(), dist.get_rank()
    model = 2 if world % 2 == 0 and world >= 2 else 1
    data = world // model
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    d, m = divmod(rank, model)
    data_groups = [dist.new_group([q * model + j for q in range(data)]) for j in range(model)]
    model_groups = [dist.new_group([q * model + j for j in range(model)]) for q in range(data)]
    return Grid(data=data, model=model, d=d, m=m, device=device,
                data_group=data_groups[m], model_group=model_groups[d],
                env=EnvSharding(rank=d, world_size=data, device=device, group=data_groups[m]))


def _cols(width: int, grid: Grid) -> slice:
    size = width // grid.model
    return slice(grid.m * size, (grid.m + 1) * size)


def trunk_rows(grid: Grid, half: int = 128) -> torch.Tensor:
    """The rows of apx's ``trunk.w`` (its input features) that this model
    rank holds: the m-th block of the ``prop`` half [0, half) and the m-th
    block of the ``map_proj`` half [half, 2 half), which meet the local
    activations ``[prop block m, map block m]``."""
    block = torch.arange(half)[_cols(half, grid)]
    return torch.cat([block, half + block])


def shard_net(net: nn.Module, grid: Grid) -> nn.Module:
    """Make ``net`` (a whole ``PPONet`` or ``R2D2Net``, the same on every
    rank) this rank's tensor-parallel shard, in place: ``prop`` and
    ``map_proj`` keep their m-th block of output columns, ``trunk`` its
    ``trunk_rows``; the rest stays replicated. The sharded leaves are
    marked ``tp_sharded`` (the global norm sums them over ``model``)."""
    with torch.no_grad():
        for name in ("prop", "map_proj"):
            layer = getattr(net, name)
            cols = _cols(layer.out_features, grid)
            layer.weight = nn.Parameter(layer.weight[cols].clone())
            layer.bias = nn.Parameter(layer.bias[cols].clone())
            layer.out_features = layer.weight.shape[0]
        rows = trunk_rows(grid, net.prop.weight.shape[0] * grid.model).to(grid.device)
        net.trunk.weight = nn.Parameter(net.trunk.weight[:, rows].clone())
        net.trunk.in_features = net.trunk.weight.shape[1]
    for p in (net.prop.weight, net.prop.bias, net.map_proj.weight, net.map_proj.bias,
              net.trunk.weight):
        p.tp_sharded = True
    net.grid = grid
    return net


# ---------------------------------------------------------------------------
# Ranks: launching, and the rank program


def rank_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags of a rank program: ``--rank``, ``--world``, ``--init``,
    ``--device``, ``--backend`` (none of them under ``torchrun``)."""
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--init", default=None, help="file:// or tcp:// rendezvous")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: by device)")
    return ap


def init_rank(args) -> Grid:
    """Join the process group the flags describe and build the grid."""
    kwargs = {} if args.init is None else {"init_method": args.init, "rank": args.rank,
                                          "world_size": args.world}
    init_distributed(backend=args.backend, device=args.device, **kwargs)
    return make_dp_tp_grid(args.device)


def spawn_grid(module: str, world: int, device: str, backend: str | None,
               extra: list[str], timeout: float = SPAWN_TIMEOUT_S) -> list[str]:
    """Run ``python -m <module>`` as ``world`` ranks (a FileStore in a
    temporary directory), from the repo root; kill any still running after
    ``timeout`` s. Returns their standard outputs; a nonzero exit raises
    with its output."""
    store = tempfile.mkdtemp(prefix="apx_grid_")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    flags = ["--world", str(world), "--init", f"file://{store}/store", "--device", device]
    if backend is not None:
        flags += ["--backend", backend]
    procs = [subprocess.Popen([sys.executable, "-m", module, "--rank", str(r), *flags, *extra],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        try:
            os.remove(f"{store}/store")
        except FileNotFoundError:
            pass
        os.rmdir(store)
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{module} rank {r} exited {p.returncode}:\n{out[-3000:]}\n"
                               f"{err[-3000:]}")
    return [out for out, _ in outs]


def _default_launch() -> tuple[int, str, str]:
    """(world, device, backend) of a plain ``python -m`` run: one rank per
    card over nccl with two or more cards, else four gloo ranks sharing
    ``cuda:0``."""
    resolve_device("cuda")
    cards = torch.cuda.device_count()
    return (cards, "cuda", "nccl") if cards >= 2 else (4, "cuda:0", "gloo")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup_rank(grid: Grid, num_envs: int, seed: int, init=init_net):
    """(venv, params, local obs, local state, generator, whole net) on
    every rank alike: the reset draws of the whole batch, kept block."""
    venv, params = make_vec("LIDARLocRooms-v0", num_envs, device=grid.device)
    g = torch.Generator(grid.device).manual_seed(seed)
    draws = venv.env.draw_reset(num_envs, params, g)
    obs, state, _ = local_venv(venv, grid.env).reset(params,
                                                     draws=shard_env_batch(grid.env, draws))
    net = init(g, params.map_bank.map_hw, grid.device)
    return venv, params, obs, state, g, net


def ppo_check(grid: Grid, num_envs: int, rollout_len: int, num_minibatches: int,
              seed: int = 3) -> dict:
    """One PPO iteration on the grid and the same iteration in one process
    (this rank, the whole batch, a generator seeded alike): the mean
    rewards, the largest |difference| of this rank's ``trunk.w`` rows from
    the one-process net's same rows, and the shape this rank holds."""
    opt = ClipAdam(0.5, 3e-4)
    venv, params, obs, state, g, net = setup_rank(grid, num_envs, seed)
    shard_net(net, grid)
    train_iter = make_train_iter(venv, opt, num_envs, rollout_len,
                                 num_minibatches=num_minibatches, grid=grid)
    _sync(grid.device)
    t0 = time.perf_counter()
    _, _, mean_r = train_iter(net, opt.init(net), state, obs, g, params)
    _sync(grid.device)
    seconds = time.perf_counter() - t0

    solo_g = torch.Generator(grid.device).manual_seed(seed)
    solo_obs, solo_state, _ = venv.reset(params, solo_g)
    solo = init_net(solo_g, params.map_bank.map_hw, grid.device)
    solo_iter = make_train_iter(venv, opt, num_envs, rollout_len, num_minibatches=num_minibatches)
    _, _, solo_r = solo_iter(solo, opt.init(solo), solo_state, solo_obs, solo_g, params)
    return {"mean_reward": float(mean_r), "solo_mean_reward": float(solo_r),
            "trunk_shape": list(net.trunk.weight.shape),
            "trunk_max_abs_diff": trunk_diff(net, solo, grid), "seconds": seconds}


def trunk_diff(shard: nn.Module, whole: nn.Module, grid: Grid) -> float:
    """The largest |difference| of a shard's ``trunk.w`` rows from the same
    rows of the one-process net."""
    rows = trunk_rows(grid).to(grid.device)
    return float((shard.trunk.weight - whole.trunk.weight[:, rows]).abs().max())


def trunk_worst_grad(shard: nn.Module, whole: nn.Module, whole_grad: torch.Tensor,
                     grid: Grid) -> float:
    """|``whole_grad``| at the ``trunk.w`` entry where the shard's weight
    differs most from the one-process net's (``trunk_grad_diff``: near
    Adam's eps, 1e-8, rounding moves the step)."""
    rows = trunk_rows(grid).to(grid.device)
    d = (shard.trunk.weight - whole.trunk.weight[:, rows]).abs()
    return float(whole_grad[:, rows].reshape(-1)[d.argmax()].abs())


def trunk_grad_diff(shard_grad: torch.Tensor, whole_grad: torch.Tensor, grid: Grid) -> float:
    """The largest |difference| of a shard's ``trunk.w`` gradient (summed
    over the data ranks, clipped) from the one-process gradient's same
    rows, relative to the latter's largest entry. Taken on equal nets it
    differs by the order of summation only, unlike the weights after Adam's
    steps: Adam divides each step by sqrt(v) + 1e-8, so an entry whose
    gradient sums to ~1e-9 moves by up to ~lr / 10 on a rounding error of
    that size."""
    ref = whole_grad[:, trunk_rows(grid).to(whole_grad.device)]
    return float((shard_grad - ref).abs().max() / ref.abs().max())


def launch(module: str, args, rank_fn, extra: list[str]) -> dict:
    """A recipe's ``main``: under a rank's flags (or ``torchrun``) run
    ``rank_fn(grid, args)`` as this rank and print its ``RANK {json}`` line;
    otherwise spawn the ranks (``--world``, or ``_default_launch``) with
    ``extra`` as their arguments. Returns rank 0's dict (with its grid,
    backend and world)."""
    if args.rank is not None or "RANK" in os.environ:
        grid = init_rank(args)
        try:
            out = rank_fn(grid, args) | {"grid": [grid.data, grid.model],
                                         "backend": dist.get_backend(),
                                         "world": dist.get_world_size()}
        finally:
            dist.destroy_process_group()
        print("RANK " + json.dumps(out), flush=True)
        return out
    world, device, backend = ((args.world, args.device, args.backend) if args.world
                              else _default_launch())
    outs = spawn_grid(module, world, device, backend, extra)
    return json.loads(next(ln for ln in outs[0].splitlines() if ln.startswith("RANK "))[5:])


def _ppo_rank(grid: Grid, args) -> dict:
    opt = ClipAdam(0.5, 3e-4)
    venv, params, obs, state, g, net = setup_rank(grid, args.num_envs, args.seed)
    shard_net(net, grid)
    opt_state = opt.init(net)
    train_iter = make_train_iter(venv, opt, args.num_envs, args.rollout_len, grid=grid)
    rewards = []
    _sync(grid.device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, obs, mean_r = train_iter(net, opt_state, state, obs, g, params)
        rewards.append(float(mean_r))
    _sync(grid.device)
    return {"trunk_shape": list(net.trunk.weight.shape), "rewards": rewards,
            "seconds": time.perf_counter() - t0}


def main(num_envs=None, iters=None, quiet=False, rollout_len=16):
    ap = rank_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("num_envs", type=int, nargs="?", default=num_envs or 256)
    ap.add_argument("iters", type=int, nargs="?", default=iters or 10)
    ap.add_argument("--rollout-len", type=int, default=rollout_len)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    spawned = args.rank is None and "RANK" not in os.environ
    out = launch("apx_torch.examples.train_ppo_mesh", args, _ppo_rank,
                 [str(args.num_envs), str(args.iters), "--rollout-len", str(args.rollout_len),
                  "--seed", str(args.seed)])
    if spawned and not quiet:
        report(out, args.num_envs * args.rollout_len * args.iters, 5, "learner update")
    return out["rewards"][-1]


def report(out: dict, env_steps: int, every: int, what: str) -> None:
    """Print rank 0's rewards every ``every`` iterations and its rate."""
    for i, r in enumerate(out["rewards"]):
        if i % every == 0 or i == len(out["rewards"]) - 1:
            print(f"iter {i}: mean step reward {r:+.4f}")
    print(f"{env_steps / out['seconds']:,.0f} env-steps/s incl. {what} on a "
          f"{out['grid'][0]}x{out['grid'][1]} (data, model) grid of {out['world']} "
          f"{out['backend']} ranks")

if __name__ == "__main__":
    main()
