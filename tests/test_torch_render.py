"""apx_torch.render against apx.render on the CPU: the frames of the
compat adapter's ``render()`` after reference-mode steps, equal to apx's
for each family, and the renderer's array helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apx.compat as jc
import apx.render.render as jr
import apx.render.style as js

import apx_torch.compat as tc
import apx_torch.render.render as tr
import apx_torch.render.style as ts

torch.set_num_threads(1)


@pytest.mark.parametrize("env_id,n,steps", [
    ("LIDARLocRooms-v0", 4, 6),
    ("LIDARLocMaze-v0", 4, 3),
    ("LightDark-v0", 4, 8),
    ("CircleSquare-v0", 4, 18),
    ("MNIST-v0", 4, 5),
    ("CIFAR10-v0", 4, 5),
    ("TinyImageNetLoc-v0", 1, 4),
])
def test_vector_frames_equal_apx(env_id, n, steps):
    """``render()`` (env 0, with the tracker's trail, fog, overlay and
    markers) after reset and ``steps`` steps, pixel for pixel apx's;
    CircleSquare's 18 steps cross its LOCKSTEP boundary (the overlay is
    cleared)."""
    j = jc.make_vec(env_id, num_envs=n, log_wrapper=False)
    t = tc.make_vec(env_id, num_envs=n, device="cpu", log_wrapper=False)
    j.reset(seed=1)
    t.reset(seed=1)
    np.testing.assert_array_equal(j.render(), t.render())
    rng = np.random.default_rng(2)
    k = j.single_action_space["prediction"].shape[-1]
    for _ in range(steps):
        act = {"action": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
               "prediction": rng.uniform(-1, 1, (n, k)).astype(np.float32)}
        j.step(act)
        t.step(act)
    fj, ft = j.render(), t.render()
    assert fj.dtype == ft.dtype == np.uint8 and fj.shape == ft.shape
    np.testing.assert_array_equal(fj, ft)


@pytest.mark.parametrize("env_id", ["LIDARLocRoomsStatic-v0", "CircleSquare-v0"])
def test_single_env_frames_equal_apx(env_id):
    j, t = jc.make(env_id), tc.make(env_id, device="cpu")
    j.reset(seed=4)
    t.reset(seed=4)
    rng = np.random.default_rng(0)
    for _ in range(5):
        act = {"action": rng.uniform(-1, 1, 2).astype(np.float32),
               "prediction": rng.uniform(-1, 1, 2).astype(np.float32)}
        j.step(act)
        t.step(act)
    np.testing.assert_array_equal(j.render(), t.render())


@pytest.mark.parametrize("seed", range(4))
def test_stamp_rect_matches_apx(seed):
    """Batched footprint stamps, edge-clipped ones included, and the
    quality map: bitwise apx's ``stamp_rect``."""
    rng = np.random.default_rng(seed)
    n, h, w = 5, 40, 56
    centers = rng.uniform(-8, w + 8, (n, 2))
    size = rng.uniform(0, 12, 2)
    quality = rng.uniform(-0.5, 1.5, n)
    out = []
    for mod in (jr, tr):
        counts = np.zeros((n, h, w), np.int32)
        qmap = np.zeros((n, h, w), np.float32)
        for _ in range(3):
            mod.stamp_rect(counts, qmap, centers, size, quality)
        out.append((counts, qmap))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_overlay_helpers_and_palette_match_apx():
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 3, (20, 30))
    qmap = rng.uniform(-0.2, 1.2, (20, 30)).astype(np.float32)
    oj = jr.visitation_overlay(counts, qmap, 0.25, 0.5)
    ot = tr.visitation_overlay(counts, qmap, 0.25, 0.5)
    np.testing.assert_array_equal(oj, ot)
    frame = rng.integers(0, 256, (20, 30, 3)).astype(np.float64)
    np.testing.assert_array_equal(jr.blend_overlay(frame, oj), tr.blend_overlay(frame, ot))
    q = rng.uniform(-1, 2, 50)
    np.testing.assert_array_equal(js.quality_colors(q), ts.quality_colors(q))
    assert [js.quality_color(x) for x in q] == [ts.quality_color(x) for x in q]
    assert (ts.COLOR_AGENT, ts.COLOR_PRED) == (js.COLOR_AGENT, js.COLOR_PRED)


def test_light_dark_brightness_field_matches_apx():
    """The renderer's field: the port's ``brightness`` with the squares
    rounded apart (``fused=False``) is bitwise apx's unjitted call; the
    env's contracted form is not, on this grid."""
    from apx.envs.light_dark import LightDarkEnv as JLD
    from apx.envs.light_dark import brightness as jb

    from apx_torch.envs.light_dark import LightDarkEnv, brightness

    xs = np.linspace(-1, 1, 200, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs), axis=-1)
    ref = np.asarray(jb(jnp.asarray(grid), JLD().default_params()))
    p = LightDarkEnv(device="cpu").default_params()
    np.testing.assert_array_equal(ref, brightness(torch.from_numpy(grid), p, fused=False).numpy())
    assert (brightness(torch.from_numpy(grid), p).numpy() != ref).any()
    assert jax.devices()[0].platform == "cpu"
