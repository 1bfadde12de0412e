"""Batch-render GIFs for the visual envs (counterpart of apx.tools.create_gifs
and of the reference's tools/create_gifs.bash driving ap-gym-create-env-vid
over 34 envs). It needs gymnasium, pillow and imageio.

Usage: python -m apx_torch.tools.create_gifs [--out doc/img] [--steps 48]
         [--device cuda]
"""

from __future__ import annotations

import argparse
import os

# The 34 ids the reference's tools/create_gifs.bash drives
# (create_gifs.bash:6-41), plus apx's extras at the end.
VISUAL_ENVS = [
    "LightDark-v0",
    "CircleSquare-v0",
    "CircleSquare-s28-v0",
    "CircleSquare-nograd-v0",
    "CircleSquare-s15-v0",
    "CircleSquare-s15-nograd-v0",
    "CircleSquare-s20-v0",
    "CircleSquare-s20-nograd-v0",
    "DoubleCircleSquare-v0",
    "DoubleCircleSquare-s28-v0",
    "DoubleCircleSquare-nograd-v0",
    "DoubleCircleSquare-s15-v0",
    "DoubleCircleSquare-s15-nograd-v0",
    "DoubleCircleSquare-s20-v0",
    "DoubleCircleSquare-s20-nograd-v0",
    "MNIST-v0",
    "MNIST-train-v0",
    "MNIST-test-v0",
    "TinyImageNet-v0",
    "TinyImageNet-train-v0",
    "TinyImageNet-test-v0",
    "TinyImageNetLoc-v0",
    "TinyImageNetLoc-train-v0",
    "TinyImageNetLoc-test-v0",
    "CIFAR10-v0",
    "CIFAR10-train-v0",
    "CIFAR10-test-v0",
    "CIFAR10Loc-v0",
    "CIFAR10Loc-train-v0",
    "CIFAR10Loc-test-v0",
    "LIDARLocMaze-v0",
    "LIDARLocMazeStatic-v0",
    "LIDARLocRooms-v0",
    "LIDARLocRoomsStatic-v0",
    # apx's extras beyond the reference's list
    "CircleSquareHideAndSeek-v0",
    "MNISTLoc-v0",
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="doc/img")
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--ids", nargs="*", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from .create_env_vid import create_env_vid

    os.makedirs(args.out, exist_ok=True)
    for env_id in args.ids or VISUAL_ENVS:
        path = os.path.join(args.out, f"{env_id}.gif")
        try:
            n = create_env_vid(env_id, path, steps=args.steps, device=args.device)
            print(f"{env_id}: {n} frames -> {path}")
        except NotImplementedError as e:
            print(f"{env_id}: skipped ({e})")


if __name__ == "__main__":
    main()
