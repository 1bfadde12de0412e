"""Env-batch data parallelism of the port over ``torch.distributed``."""

from .mesh import (
    COLLECTIVE_BYTES,
    BankShard,
    EnvSharding,
    init_distributed,
    local_venv,
    make_env_mesh,
    shard_env_batch,
    shard_params,
    sharded_rollout,
    sharded_vector_env_step,
)
from .metrics import all_mean, all_sum, episode_stats_psum

__all__ = [
    "BankShard",
    "COLLECTIVE_BYTES",
    "EnvSharding",
    "all_mean",
    "all_sum",
    "episode_stats_psum",
    "init_distributed",
    "local_venv",
    "make_env_mesh",
    "shard_env_batch",
    "shard_params",
    "sharded_rollout",
    "sharded_vector_env_step",
]
