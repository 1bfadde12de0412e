"""Cross-rank metric reductions (counterpart of apx.distrib.metrics).

The reference aggregates episode metrics on the host per process. Across
ranks the same aggregates are sums over the env axis: apx takes them as
``psum``s inside ``shard_map``, the port as ``all_reduce``s over the
process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_sum", "all_mean", "episode_stats_psum"]


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    return all_sum(x, group) / dist.get_world_size(group)


def episode_stats_psum(stats: dict, done: torch.Tensor, group=None) -> dict:
    """Reduce per-env episode stats (the metrics wrappers' flat dict of
    (N,) entries) over this rank's block and all ranks into global scalars:
    the done-weighted mean of every float entry whose name does not start
    with "_", and ``episodes``, the global count of completed episodes.
    Not-done envs (NaN stats) are masked: NaN -> 0 where not done, and the
    denominator is ``max(n_done, 1)``. One ``all_reduce`` per float dtype
    among the stats."""
    keys = [k for k, v in stats.items()
            if not k.startswith("_") and v.dtype in (torch.float32, torch.float64)]
    sums = {}
    for dtype in (torch.float32, torch.float64):
        group_keys = [k for k in keys if stats[k].dtype == dtype]
        local = [torch.where(done, torch.nan_to_num(stats[k]), 0.0).sum() for k in group_keys]
        if dtype == torch.float32:
            group_keys.insert(0, "episodes")
            local.insert(0, done.to(torch.float32).sum())
        if not local:
            continue
        total = torch.stack(local)
        dist.all_reduce(total, group=group)
        sums.update(zip(group_keys, total))
    n_done = sums.pop("episodes")
    denom = torch.clamp_min(n_done, 1.0)
    return {"episodes": n_done, **{k: sums[k] / denom.to(sums[k].dtype) for k in keys}}
