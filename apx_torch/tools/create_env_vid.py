"""Random-policy rollout -> GIF, for any registered env (counterpart of
apx.tools.create_env_vid).

Behavioral reference: the reference's ap_gym/tools/create_env_vid.py:11-60
(console script ``ap-gym-create-env-vid``; drives a random policy and
writes imageio GIFs at the env's render_fps). The rollout goes through
``apx_torch.compat.make`` on ``--device`` (the card by default); its frames
are apx's for the same seed. It needs gymnasium, pillow and imageio.

Usage: python -m apx_torch.tools.create_env_vid CircleSquare-v0 out.gif
         [--steps 64] [--seed 0] [--fps 4] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np


def create_env_vid(
    env_id: str,
    output_path: str,
    steps: int = 64,
    seed: int = 0,
    fps: int | None = None,
    device="cuda",
) -> int:
    import imageio

    import apx_torch.compat as apc

    env = apc.make(env_id, device=device)
    rng = np.random.default_rng(seed)
    env.reset(seed=seed)
    frames = [env.render()]
    for _ in range(steps):
        act = {
            "action": rng.uniform(-1, 1, env.action_space["action"].shape).astype(
                np.float32
            ),
            "prediction": rng.normal(
                size=env.prediction_space.shape
            ).astype(np.float32)
            if env.prediction_space.shape
            else (),
        }
        _, _, term, trunc, _ = env.step(act)
        frames.append(env.render())
        if (term or trunc) and not _autoresets(env):
            env.reset()
    fps = fps or env.metadata.get("render_fps", 4)
    imageio.mimsave(output_path, frames, fps=fps, loop=0)
    return len(frames)


def _autoresets(env) -> bool:
    # apx's rule; the port's vector shell keeps its mode on its core.
    vec = getattr(env, "_vec", None)
    return vec is not None and getattr(vec, "core", vec).autoreset != "none"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("env_id")
    ap.add_argument("output_path")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    n = create_env_vid(args.env_id, args.output_path, args.steps, args.seed, args.fps,
                       args.device)
    print(f"wrote {n} frames to {args.output_path}")


if __name__ == "__main__":
    main()
