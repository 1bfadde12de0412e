"""Functional-API example: a random-policy rollout on any env (the twin of
apx's ``examples/rollout_functional.py``).

The counterpart of the reference's example scripts, which drive random
policies through the gymnasium API one step at a time: here the batched
vector env steps all N envs at once on the card (uniform actions in
[-1, 1], standard-normal predictions, every draw from one
``torch.Generator`` on the device), with the id's metrics wrapper.

    python -m apx_torch.examples.rollout_functional [env_id] [num_envs] [steps]
"""

from __future__ import annotations

import sys
import time

import torch

from ..registry import _device as resolve_device
from ..registry import make_vec

__all__ = ["run", "main"]


def run(env_id="LIDARLocRooms-v0", num_envs=1024, steps=256, device="cuda", seed=0) -> dict:
    """The rollout and its figures: env-steps/s, the mean reward, the
    episodes finished and the nan-mean of the first ``avg_*`` episode
    statistic over the steps."""
    dev = resolve_device(device)
    venv, params = make_vec(env_id, num_envs, device=dev, metrics=True)
    act_shape = venv.env.inner_action_space(params).shape
    pred_shape = venv.env.prediction_space(params).shape
    g = torch.Generator(dev).manual_seed(seed)

    def policy(g, obs):
        return {"action": torch.rand((num_envs, *act_shape), generator=g, device=dev) * 2.0 - 1.0,
                "prediction": torch.randn((num_envs, *pred_shape), generator=g, device=dev)}

    t0 = time.perf_counter()
    obs, state, _ = venv.reset(params, g)
    rewards, dones, metric = [], [], []
    for _ in range(steps):
        obs, state, reward, term, trunc, info = venv.step(state, policy(g, obs), params, g)
        stats = info["stats"]["scalar"]
        rewards.append(reward.mean())
        dones.append((term | trunc).sum())
        metric.append(next(stats[k] for k in stats
                           if k.startswith("avg_") and not k.startswith("_")))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    return {"env_id": env_id, "env_steps_per_s": num_envs * steps / dt,
            "mean_reward": float(torch.stack(rewards).mean()),
            "episodes": int(torch.stack(dones).sum()),
            "metric": float(torch.nanmean(torch.stack(metric)))}


def main():
    env_id = sys.argv[1] if len(sys.argv) > 1 else "LIDARLocRooms-v0"
    num_envs = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    res = run(env_id, num_envs, steps)
    print(f"{env_id}: {res['env_steps_per_s']:,.0f} env-steps/s, mean reward "
          f"{res['mean_reward']:+.3f}, {res['episodes']} episodes finished")


if __name__ == "__main__":
    main()
