"""Gymnasium-compat example: drive the port exactly as the reference's
example scripts drive ap_gym (the twin of apx's ``examples/gym_compat.py``).

``apx_torch.compat.make`` is the gymnasium drop-in (numpy in and out, the
env on the card); it needs gymnasium.

    python -m apx_torch.examples.gym_compat [env_id]
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["run", "main"]


def run(env_id="CircleSquare-v0", steps=64, device="cuda", quiet=False) -> float:
    """A 64-step episode stream with seeded uniform actions and normal
    predictions; prints each finished episode's statistics and returns the
    summed reward."""
    from .. import compat as apc

    env = apc.make(env_id, device=device)
    rng = np.random.default_rng(0)
    env.reset(seed=0)
    total = 0.0
    for t in range(steps):
        action = {
            "action": rng.uniform(-1, 1, env.action_space["action"].shape).astype(np.float32),
            "prediction": rng.normal(size=env.prediction_space.shape).astype(np.float32),
        }
        _, reward, _, _, info = env.step(action)
        total += float(reward)
        if "stats" in info and not quiet:
            scalars = {k: round(float(v), 3) for k, v in info["stats"]["scalar"].items()
                       if not k.startswith("_") and np.ndim(v) == 0}
            print(f"episode done at t={t}: {scalars}")
    if not quiet:
        print(f"return over {steps} steps: {total:+.2f}")
    return total


def main():
    run(sys.argv[1] if len(sys.argv) > 1 else "CircleSquare-v0")


if __name__ == "__main__":
    main()
