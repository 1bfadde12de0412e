"""The port's ImagePerceptionModule (apx_torch.compat.perception_module),
which senses on its device, against apx.compat.perception_module on the
CPU: from one seed and one stream of numpy actions and qualities, every
observation, reward, done, info, label, position, canvas and frame
bitwise; the unique positions equal on every env (their scores are summed
in numpy's order, so the drift is 0 and every ranking is decided);
``_bilinear_batch`` in torch bitwise apx's numpy kernel (itself pinned to
scipy in tests/test_perception_module.py)."""

import jax  # noqa: F401  (conftest pins the cpu backend)
import numpy as np
import pytest
import torch

from apx.compat import dataset_classes as adc, perception_module as apm
from apx_torch.compat import dataset_classes as tdc, perception_module as tpm

torch.set_num_threads(1)

N = 8
STEPS = 40  # two 16-step episodes, their lockstep rollovers and 6 more steps


def _pair(num_envs=N, seed=1234, **cfg):
    ours = tpm.ImagePerceptionModule(
        num_envs, tpm.ImagePerceptionConfig(dataset=tdc.CircleSquareDataset(), prefetch=False,
                                            **cfg), device="cpu")
    theirs = apm.ImagePerceptionModule(
        num_envs, apm.ImagePerceptionConfig(dataset=adc.CircleSquareDataset(), prefetch=False,
                                            **cfg))
    ours.seed(seed)
    theirs.seed(seed)
    return ours, theirs


def _same_obs(a, b):
    assert list(a) == list(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _same_state(ours, theirs, what):
    np.testing.assert_array_equal(ours.current_labels, theirs.current_labels, err_msg=what)
    np.testing.assert_array_equal(ours._episode.pos, theirs._episode.pos, err_msg=what)
    np.testing.assert_array_equal(ours._episode.pos_dev.numpy(), theirs._episode.pos,
                                  err_msg=what)
    np.testing.assert_array_equal(ours.current_images, theirs.current_images, err_msg=what)
    np.testing.assert_array_equal(ours._canvas.counts, theirs._canvas.counts, err_msg=what)
    np.testing.assert_array_equal(ours._canvas.quality, theirs._canvas.quality, err_msg=what)


@pytest.mark.parametrize("cfg", [{}, {"randomly_invert_labels": True}],
                         ids=["plain", "inverted"])
def test_episode_stream_matches_apx_bitwise(cfg):
    """Reset and 40 steps (two lockstep rollovers): every channel, reward,
    done and info, the labels, positions (host and device), images and
    canvases bitwise; the inversion bit visible at t=0 only."""
    ours, theirs = _pair(**cfg)
    obs_a, info_a = ours.reset()
    obs_b, info_b = theirs.reset()
    _same_obs(obs_a, obs_b)
    np.testing.assert_array_equal(info_a["index"], info_b["index"])
    _same_state(ours, theirs, "reset")
    rng = np.random.default_rng(7)
    rollovers = 0
    for t in range(STEPS):
        action = rng.uniform(-1.8, 1.8, size=(N, 2))  # exercises project_sphere
        quality = rng.uniform(-0.2, 1.2, size=N)  # exercises the [0, 1] clip
        ra = ours.step(action, quality)
        rb = theirs.step(action, quality)
        _same_obs(ra[0], rb[0])
        for x, y, what in zip(ra[1:4], rb[1:4], ("reward", "terminated", "truncated")):
            assert np.asarray(x).dtype == np.asarray(y).dtype, what
            np.testing.assert_array_equal(x, y, err_msg=f"{what} t={t}")
        np.testing.assert_array_equal(ra[4]["index"], rb[4]["index"])
        _same_state(ours, theirs, f"t={t}")
        rollovers += int(ra[0]["time_step"][0] == -1.0)
        if cfg:
            assert (ra[0]["inverted_label"] == 2).all() == (ra[0]["time_step"][0] != -1.0)
    assert rollovers == 2
    ours.close()
    theirs.close()


def test_nonsquare_scaled_sensor_and_guards_match_apx():
    """A non-square sensor with sensor_scale 2 (the flipped stamp and the
    reference's unflipped box), then the NaN and partial-reset guards."""
    ours, theirs = _pair(num_envs=2, seed=77, sensor_size=(3, 5), sensor_scale=2.0)
    _same_obs(ours.reset()[0], theirs.reset()[0])
    rng = np.random.default_rng(1)
    for _ in range(6):
        action = rng.uniform(-1, 1, size=(2, 2))
        quality = rng.uniform(0, 1, size=2)
        ra, rb = ours.step(action, quality), theirs.step(action, quality)
        _same_obs(ra[0], rb[0])
        np.testing.assert_array_equal(ra[1], rb[1])
    assert ra[0]["glimpse"].shape == (2, 3, 5, 1)
    _same_state(ours, theirs, "after 6 steps")
    np.testing.assert_array_equal(ours.render(), theirs.render())
    for mod in (ours, theirs):
        with pytest.raises(ValueError, match="prediction"):
            mod.step(np.zeros((2, 2)), np.array([np.nan, 0.0]))
        with pytest.raises(ValueError, match="action"):
            mod.step(np.full((2, 2), np.nan), np.zeros(2))
        mod._rollover = np.array([True, False])
        with pytest.raises(NotImplementedError):
            mod.step(np.zeros((2, 2)), np.zeros(2))
    # A sensor larger than the image is refused at the reset, as in apx.
    for mod in _pair(num_envs=2, sensor_size=(30, 5)):
        mod.seed(0)
        with pytest.raises(ValueError, match="effective sensor size"):
            mod.reset()


def test_render_frames_and_geometry_match_apx():
    ours, theirs = _pair(num_envs=2)
    ours.reset()
    theirs.reset()
    rng = np.random.default_rng(3)
    for _ in range(4):
        action, quality = rng.uniform(-1, 1, size=(2, 2)), rng.uniform(0, 1, size=2)
        ours.step(action, quality)
        theirs.step(action, quality)
    np.testing.assert_array_equal(ours.render(), theirs.render())
    fa, fb = ours.render(return_pil_imgs=True), theirs.render(return_pil_imgs=True)
    assert [f.size for f in fa] == [f.size for f in fb]
    np.testing.assert_array_equal(np.asarray(fa[1]), np.asarray(fb[1]))
    assert tuple(ours.render_size) == tuple(theirs.render_size)
    assert ours.render_scaling == theirs.render_scaling
    assert ours.glimpse_border_width == theirs.glimpse_border_width
    pts = np.random.default_rng(0).uniform(-1, 1, (2, 2))
    for name in ("denormalize_coords", "to_render_coords", "normalize_coords"):
        np.testing.assert_array_equal(getattr(ours, name)(pts), getattr(theirs, name)(pts))
    np.testing.assert_array_equal(ours.sensor_pos_lim_pixels, theirs.sensor_pos_lim_pixels)
    np.testing.assert_array_equal(ours.current_sensor_pos, theirs.current_sensor_pos)


@pytest.mark.parametrize("cfg", [{}, {"randomly_invert_labels": True},
                                 {"sensor_size": (3, 5), "sensor_scale": 2.0}],
                         ids=["plain", "inverted", "nonsquare"])
def test_unique_positions_match_apx_on_every_env(cfg):
    """``sample_unique_glimpse_positions`` after a reset and a few steps:
    the scores bitwise apx's (so every env's top-k is decided: the drift is
    0), and the positions equal on every env."""
    ours, theirs = _pair(seed=99, **cfg)
    ours.reset()
    theirs.reset()
    for _ in range(3):
        ours.step(np.full((N, 2), 0.3), np.zeros(N))
        theirs.step(np.full((N, 2), 0.3), np.zeros(N))
    _, grid = theirs._candidate_grid()
    want = apm._pairwise_uniqueness(theirs.get_glimpse(grid[None]))
    got = ours._uniqueness_scores(grid)
    drift = float(np.abs(got - want).max())
    assert drift == 0.0
    np.testing.assert_array_equal(got[2:5], ours._uniqueness_scores(grid, slice(2, 5)))
    np.testing.assert_array_equal(ours.sample_unique_glimpse_positions(),
                                  theirs.sample_unique_glimpse_positions())


@pytest.mark.parametrize("n,h,w,c", [(4, 13, 9, 3), (3, 28, 28, 1), (2, 6, 17, 1)])
def test_bilinear_batch_matches_apx_numpy(n, h, w, c):
    """Points exactly on nodes, on the first and last nodes and at half
    cells (the searchsorted edge cases), and random ones, float32 images,
    two point layouts (per env, and one grid broadcast to every env)."""
    rng = np.random.default_rng(42)
    images = rng.uniform(0, 1, size=(n, h, w, c)).astype(np.float32)
    grid_y = np.arange(h) - (h - 1) / 2
    grid_x = np.arange(w) - (w - 1) / 2
    pts = rng.uniform([grid_y[0], grid_x[0]], [grid_y[-1], grid_x[-1]], size=(n, 6, 5, 2))
    pts[:, 0, 0] = (grid_y[3], grid_x[2])
    pts[:, 0, 1] = (grid_y[0], grid_x[0])
    pts[:, 0, 2] = (grid_y[-1], grid_x[-1])
    pts[:, 0, 3] = (grid_y[4] + 0.5, grid_x[5] + 0.5)
    shared = pts[:1, 1:]
    for points in (pts, shared):
        want = apm._bilinear_batch(images, points)
        got = tpm._bilinear_batch(torch.as_tensor(images), torch.as_tensor(points))
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 4, 25, 75, 129, 300])
def test_pairwise_uniqueness_matches_apx_numpy(k):
    """The score sums its k = s0 * s1 * C terms in numpy's pairwise order:
    sequential below 8, eight partial sums to 128, halves above."""
    rng = np.random.default_rng(k)
    glimpses = rng.uniform(0, 1, size=(3, 20, k, 1, 1)).astype(np.float32)
    want = apm._pairwise_uniqueness(glimpses)
    got = tpm._pairwise_uniqueness(torch.as_tensor(glimpses)).numpy()
    np.testing.assert_array_equal(got, want)


def test_spaces_subclass_hooks_and_device():
    """Spaces equal apx's (built lazily, gymnasium imported only there),
    the space dict a stable object, both observation hooks honoured, and
    the default device the card (refused without one)."""
    ours, theirs = _pair(num_envs=3, randomly_invert_labels=True)
    assert repr(ours.observation_space_dict) == repr(theirs.observation_space_dict)
    assert repr(ours.single_inner_action_space) == repr(theirs.single_inner_action_space)
    d = ours.observation_space_dict
    assert ours.observation_space_dict is d
    d["patched"] = None
    assert "patched" in ours.observation_space_dict
    assert ours.device == torch.device("cpu")

    class ViaRefName(tpm.ImagePerceptionModule):
        def _get_obs(self):
            return {**super()._get_obs(), "extra": np.ones(3)}

    class ViaApxName(tpm.ImagePerceptionModule):
        def observe(self):
            return {**super().observe(), "extra": np.full(3, 2.0)}

    cfg = tpm.ImagePerceptionConfig(dataset=tdc.CircleSquareDataset(), prefetch=False)
    for cls, val in ((ViaRefName, 1.0), (ViaApxName, 2.0)):
        m = cls(3, cfg, device="cpu")
        m.seed(0)
        assert np.all(m.reset()[0]["extra"] == val)
        assert np.all(m.step(np.zeros((3, 2)), np.zeros(3))[0]["extra"] == val)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpm.ImagePerceptionModule(3, cfg)


def test_dataset_classes_match_apx():
    """The host datasets over the port's generators: points, batches, the
    normalization rules and the floor maps bitwise apx's."""
    idx = [0, 5, 777, 1567]
    pairs = [(tdc.CircleSquareDataset(), adc.CircleSquareDataset()),
             (tdc.CircleSquareDataset(show_gradient=False, image_shape=(15, 15)),
              adc.CircleSquareDataset(show_gradient=False, image_shape=(15, 15))),
             (tdc.DoubleCircleSquareDataset(image_shape=(20, 20)),
              adc.DoubleCircleSquareDataset(image_shape=(20, 20)))]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs) and ours.num_classes == theirs.num_classes
        for i in idx[:-1]:
            a, b = ours[i], theirs[i]
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1] and a[0].dtype == b[0].dtype
        for x, y in zip(ours[np.array(idx[:-1])], theirs[np.array(idx[:-1])]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    np.testing.assert_array_equal(tdc.FloorMapDatasetMaze(branching_prob=0.5)[[3, 9]],
                                  adc.FloorMapDatasetMaze(branching_prob=0.5)[[3, 9]])
    np.testing.assert_array_equal(tdc.FloorMapDatasetRooms(max_rooms=4)[7],
                                  adc.FloorMapDatasetRooms(max_rooms=4)[7])
    for mod in (tdc, adc):
        with pytest.raises(ValueError, match="odd"):
            mod.FloorMapDatasetMaze(width=20)
    # The normalization rules on a subclass: uint8 -> /255, HW -> HWC, gray
    # -> RGB.
    for mod in (tdc, adc):
        class Gray(mod.ImageClassificationDataset):
            def _get_num_classes(self):
                return 3

            def _get_num_channels(self):
                return 3

            def _get_length(self):
                return 4

            def _get_data_point(self, i):
                return np.full((4, 5), 40 * i, np.uint8), i % 3

        img, label = Gray()[2]
        assert img.shape == (4, 5, 3) and img.dtype == np.float32 and label == 2
        np.testing.assert_array_equal(img, np.float32(80) / 255)
