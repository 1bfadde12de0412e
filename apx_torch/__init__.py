"""apx_torch: the PyTorch / CUDA port of apx, beside the JAX package.

Batched functional active-perception environments on an NVIDIA GPU. The
port imports torch and numpy only, never JAX or the apx package, and
``datasets`` only where it loads an image corpus. It makes all 158 of
apx's ids: the LIDAR localization envs (the slab raycast and the window
cut as CUDA kernels), the CircleSquare, DoubleCircleSquare and HideAndSeek
envs, the MNIST / CIFAR10 / TinyImageNet classification and localization
envs (the bilinear glimpse as a CUDA kernel; the localization reset's
unique-target sampler), LightDark, and the ``-sparse`` twin of each, each
with ``metrics=True`` where apx has metrics. Around them: env-batch
sharding over ``torch.distributed`` (``apx_torch.distrib``), checkpoints
(``apx_torch.utils.checkpoint``), host streaming and device bank rotation
(``apx_torch.data.stream``), the native map-bank generator
(``apx_torch.data.native``), and the gymnasium drop-in adapter
(``apx_torch.compat.make`` / ``make_vec``, numpy in and out, seeded
episodes equal to apx.compat's) with its renderer (``apx_torch.render``).
The twins of apx's training recipes and small examples are in
``apx_torch.examples`` (PPO through the env's differentiable loss, and
PPO, V-trace and R2D2 on a (data, model) grid of ranks), and those of
``__graft_entry__.py``'s entry points in ``apx_torch.graft_entry``.
ROADMAP.md lists what is still to come.

    import torch, apx_torch
    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", num_envs=4096)
    g = torch.Generator(device="cuda").manual_seed(0)
    obs, state, info = venv.reset(params, g)
    act = {"action": torch.zeros(4096, 2, device="cuda"),
           "prediction": torch.zeros(4096, 2, device="cuda")}
    obs, state, reward, terminated, truncated, info = venv.step(state, act, params, g)
"""

from .core.env import (APEnv, APStepResult, AutoResetMode, VectorAPEnv, rollout,
                       rollout_episodic, vector_env)
from .registry import env_ids, make, make_vec

__all__ = [
    "APEnv",
    "APStepResult",
    "AutoResetMode",
    "VectorAPEnv",
    "env_ids",
    "make",
    "make_vec",
    "rollout",
    "rollout_episodic",
    "vector_env",
]
