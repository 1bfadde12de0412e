"""apx_torch.compat against apx.compat on the CPU for the image families,
in ``rng="reference"`` mode across LOCKSTEP boundaries: ints and bools
bitwise, glimpses within 2e-5, rewards, losses and the classification and
regression log stats within 1e-6, every dtype equal (apx's int32 labels and
indices, float64 rewards)."""

import numpy as np
import pytest
import torch

from _compat_parity import IMAGE_TOL, run_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("env_id,n,steps", [
    ("CircleSquare-v0", 8, 36),
    ("CircleSquareInverted-v0", 8, 36),
    ("CircleSquare-sparse-v0", 4, 36),
    ("MNIST-v0", 8, 36),
    ("TinyImageNetLoc-v0", 2, 20),
    ("CircleSquareHideAndSeek-v0", 4, 36),
    ("CircleSquareHideAndSeekNoPrediction-v0", 4, 36),
])
def test_make_vec_matches_apx(env_id, n, steps):
    """Seed 0 through two LOCKSTEP boundary steps (16-step episodes; 32 for
    HideAndSeek, one boundary), and TinyImageNetLoc's reset from the host
    unique-target sweep (scipy, per env) and its first boundary."""
    _, _, err, dones = run_pair(env_id, n, steps, tol=IMAGE_TOL)
    assert dones >= n
    assert err.get("glimpse", 0.0) <= 2e-5


def test_make_single_image_matches_apx_with_log_stats():
    """``make`` of CircleSquare-v0 (a squeezed one-env LOCKSTEP vector,
    ClassificationLogWrapper): two episodes and their boundary step, with
    ``info["stats"]`` (first_correct, last_incorrect) at each end."""
    jenv, tenv, _, dones = run_pair("CircleSquare-v0", None, 36, tol=IMAGE_TOL)
    assert dones == 2
    assert type(tenv).__name__ == "ClassificationLogWrapper"
    assert tenv.spec.max_episode_steps == 16
