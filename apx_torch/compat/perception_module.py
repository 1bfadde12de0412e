"""The reference's ImagePerceptionModule as a drop-in, sensing on the card
(counterpart of apx.compat.perception_module).

The reference's ``ImagePerceptionModule`` (envs/image/image_perception_module
.py:42-477) is the engine behind its glimpse-on-image envs: it owns the
image batch, sensor position, time step, RNG, data loader and render
overlays. User code may construct it directly, so the port has it with
apx's constructor, methods, properties and host RNG draw order; what is
new is where the sensing runs:

  * The module holds the episode's image batch and sensor positions as
    tensors on its device (``device=``, the card by default; no fallback
    to the CPU). Draws, movement, rewards and the render canvases stay on
    the host in numpy, in the reference's order (``_spawn_episode``,
    ``_advance``), and observations come back as numpy arrays.
  * ``_bilinear_batch`` is apx's vectorized scipy-exact bilinear kernel
    written as one torch op per arithmetic step in float64: the cell lookup
    by ``torch.searchsorted``, offsets against the grid values, the four
    corners accumulated in (y0x0, y0x1, y1x0, y1x1) order. Every op is
    elementwise and correctly rounded on the CPU and on the card, and none
    fuses a multiply into an add, so glimpses are bitwise apx's numpy.
  * The uniqueness score of ``sample_unique_glimpse_positions`` (apx's
    ``np.mean(..., axis=(-3, -2, -1))`` of float32 squared differences)
    is summed in numpy's own order for a contiguous float32 reduction
    (pairwise: eight interleaved partial sums below 129 terms, halves
    above), one (B, P, P) slice per term, over blocks of envs, so the
    scores too are bitwise apx's on either device. The ranking is numpy's
    ``argsort`` of the scores on the host, as apx's, ties included.

Observations, rewards and infos need neither gymnasium nor pillow:
gymnasium is imported only where spaces are built
(``observation_space_dict``, ``single_inner_action_space``), pillow only by
``render``. Rendering goes through the port's ``apx_torch.render``
helpers, as apx's goes through ``apx.render``.

Intentional behavior extensions (reference quirks preserved otherwise), as
in apx: ``unique_sampling_max_grid_cell_size_rel`` is a constructor-settable
dataclass field, and space ``idoc`` annotations are omitted.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.numerics import div
from ..registry import _device
from ..render.style import COLOR_AGENT
from .dataset_classes import ImageClassificationDataset

__all__ = ["ImagePerceptionConfig", "ImagePerceptionModule"]

# Device bytes one block of the uniqueness score may hold (its (B, P, P)
# float32 partial sums and temporaries).
_SCORE_BLOCK_BYTES = 1 << 30


@dataclass(frozen=True)
class ImagePerceptionConfig:
    """(image_perception_module.py:20-34)."""

    dataset: ImageClassificationDataset
    sensor_size: tuple[int, int] = (5, 5)
    sensor_scale: float = 1.0
    max_step_length: float | Sequence[float] = 0.2
    step_limit: int = 16
    display_visitation: bool = True
    render_unvisited_opacity: float = 0.0
    render_visited_opacity: float = 0.3
    prefetch_buffer_size: int = 128
    prefetch: bool = True
    unique_sampling_max_grid_cell_size_rel: float = 0.2
    unique_sampling_top_k: int = 10
    randomly_invert_labels: bool = False


def _project_sphere(x: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Project into the unit ball (util.py:94-97)."""
    magnitude = np.linalg.norm(x, axis=-1, keepdims=True)
    direction = x / np.maximum(magnitude, radius)
    return np.where(magnitude > radius, direction * radius, x)


def _require_finite(name: str, values: np.ndarray) -> None:
    if np.any(np.isnan(values)):
        raise ValueError(f"NaN values detected in {name}.")


def _bilinear_batch(images: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of per-env images at per-env point grids.

    images: (N, H, W, C); points: float64, broadcastable to (N, ..., 2) in
    (y, x) center-origin pixel coordinates, on the images' device. Returns
    (N, ..., C) float64.

    Matches scipy RegularGridInterpolator(method="linear") bitwise on unit
    grids, as apx's numpy form does: cell lookup via searchsorted(grid, p)
    - 1 (so points exactly on a node land in the LEFT cell with weight 1 on
    the upper corner), fractional offsets measured against the actual grid
    values, and corner contributions accumulated in (y0x0, y0x1, y1x0,
    y1x1) order, one rounding per op.
    """
    n, h, w, _ = images.shape
    dev = images.device
    grid_y = torch.arange(h, dtype=torch.float64, device=dev) - (h - 1) / 2
    grid_x = torch.arange(w, dtype=torch.float64, device=dev) - (w - 1) / 2
    points = points.expand(n, *points.shape[1:])
    py, px = points[..., 0].contiguous(), points[..., 1].contiguous()
    i = (torch.searchsorted(grid_y, py) - 1).clamp(0, h - 2)
    j = (torch.searchsorted(grid_x, px) - 1).clamp(0, w - 2)
    ty = py - grid_y[i]
    tx = px - grid_x[j]
    env = torch.arange(n, device=dev).reshape((n,) + (1,) * (points.ndim - 2))
    out = torch.zeros((*points.shape[:-1], images.shape[-1]), dtype=torch.float64, device=dev)
    for di, wy in ((0, 1 - ty), (1, ty)):
        for dj, wx in ((0, 1 - tx), (1, tx)):
            out = out + images[env, i + di, j + dj] * (wy * wx)[..., None]
    return out


def _pairwise_sum(terms: Callable[[int], torch.Tensor], lo: int, n: int) -> torch.Tensor:
    """``terms(lo) + ... + terms(lo + n - 1)`` in numpy's pairwise order for
    a contiguous reduction of n elements: sequential below 8, eight
    interleaved partial sums folded as ((0+1)+(2+3))+((4+5)+(6+7)) then the
    tail up to 128, halves (the first a multiple of 8) above."""
    if n < 8:
        acc = terms(lo)
        for k in range(1, n):
            acc = acc + terms(lo + k)
        return acc
    if n <= 128:
        r = [terms(lo + j) for j in range(8)]
        i = 8
        while i < n - n % 8:
            for j in range(8):
                r[j] = r[j] + terms(lo + i + j)
            i += 8
        acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for k in range(i, n):
            acc = acc + terms(lo + k)
        return acc
    half = n // 2
    half -= half % 8
    return _pairwise_sum(terms, lo, half) + _pairwise_sum(terms, lo + half, n - half)


def _pairwise_uniqueness(glimpses: torch.Tensor) -> torch.Tensor:
    """(N, P, ...) candidate glimpses -> (N, P) float64 uniqueness score:
    each candidate's minimum MSE against every OTHER candidate of the same
    env (diagonal masked with +inf). Higher = more distinctive. The mean is
    apx's float32 ``np.mean`` over the trailing axes, term for term."""
    n, p = glimpses.shape[:2]
    g = glimpses.reshape(n, p, -1)
    k = g.shape[-1]

    def square(t: int) -> torch.Tensor:
        d = g[:, None, :, t] - g[:, :, None, t]
        return d * d

    diff = div(_pairwise_sum(square, 0, k), float(k)).double()
    diff.diagonal(dim1=-2, dim2=-1).fill_(float("inf"))
    return diff.amin(dim=-1)


@dataclass(frozen=True)
class _Episode:
    """One lockstep episode's data: swapped wholesale on reset, advanced
    via dataclasses.replace on step (never mutated in place). The image
    batch and the positions' mirror live on the module's device."""

    images: torch.Tensor  # (N, H, W, C) float, on the device
    labels: np.ndarray  # (N,)
    batch_idx: np.ndarray  # (N,) dataset indices
    inverted: np.ndarray | None  # (N,) bool, only with randomly_invert_labels
    pos: np.ndarray  # (N, 2) float64 normalized sensor position (host)
    pos_dev: torch.Tensor  # the same positions on the device
    t: int  # steps taken this episode


class _Canvas:
    """Batched visitation + prediction-quality canvas at render resolution.

    Geometry rule per the reference (module.py:167-183): render width =
    max(128, glimpse pixel width), height scaled to preserve the image
    aspect ratio. Stamping delegates to the shared
    apx_torch.render.render.stamp_rect."""

    def __init__(self, num_envs: int, image_hw, glimpse_width: int):
        width = max(128, glimpse_width)
        self.scaling = width / image_hw[1]
        self.size = (width, int(round(self.scaling * image_hw[0])))
        shape = (num_envs, self.size[1], self.size[0])
        self.counts = np.zeros(shape, dtype=np.int32)
        self.quality = np.zeros(shape, dtype=np.float32)

    def clear(self) -> None:
        self.counts.fill(0)
        self.quality.fill(0)

    def stamp(self, centers_xy, stamp_wh, quality) -> None:
        from ..render.render import stamp_rect

        stamp_rect(self.counts, self.quality, centers_xy, stamp_wh, quality)

    def overlay(self, visited_opacity: float, unvisited_opacity: float):
        from ..render.render import visitation_overlay

        return visitation_overlay(
            self.counts, self.quality, visited_opacity, unvisited_opacity
        )


def _box_space(low, high, shape):
    import gymnasium as gym

    return gym.spaces.Box(low, high, shape, np.float32)


class ImagePerceptionModule:
    """(image_perception_module.py:42-477). See the module docstring for
    where the work runs; ``device`` is the port's addition."""

    def __init__(self, num_envs: int, config: ImagePerceptionConfig, device="cuda"):
        self._config = config
        self._num_envs = num_envs
        self._device = _device(device)
        config.dataset.load()
        *self._image_size, self._channels = config.dataset[0][0].shape
        max_step_length = np.array(config.max_step_length)
        assert max_step_length.shape in {(2,), (1,), ()}
        self._max_step_length = np.ones(2) * max_step_length
        self._channel_table = self._build_channels()
        self._observation_space_dict: dict | None = None
        self._single_inner_action_space = None
        self._rng: np.random.Generator | None = None
        self._loader = None
        self._episode: _Episode | None = None
        self._canvas: _Canvas | None = None
        self._rollover: np.ndarray | None = None

    # -- observation channels ------------------------------------------------

    def _build_channels(self) -> list[tuple[str, Callable[[], Any], Callable[[_Episode], np.ndarray]]]:
        """Observation contract as data: (name, space factory, reader)
        triples, in the reference's key order. ``observe()`` and
        ``observation_space_dict`` both derive from this single table; the
        factories import gymnasium when the spaces are first asked for."""
        cfg = self._config
        n = self._num_envs

        def read_time(ep: _Episode) -> np.ndarray:
            frac = (ep.t / cfg.step_limit) * 2 - 1
            return np.full(n, frac, np.float32)

        def glimpse_space():
            from .gym_spaces import ImageSpace

            return ImageSpace(cfg.sensor_size[1], cfg.sensor_size[0], self._channels,
                              dtype=np.float32)

        def inverted_space():
            import gymnasium as gym

            return gym.spaces.Discrete(3)

        table = [
            ("glimpse", glimpse_space, lambda ep: self.get_glimpse(ep.pos_dev)),
            ("glimpse_pos", lambda: _box_space(-1, 1, (2,)),
             lambda ep: ep.pos.astype(np.float32)),
            ("time_step", lambda: _box_space(-1, 1, ()), read_time),
        ]
        if cfg.randomly_invert_labels:
            # Inversion bits are visible only at t=0; afterwards the channel
            # pins to the sentinel 2 (module.py:246-251).
            table.append((
                "inverted_label", inverted_space,
                lambda ep: ep.inverted.astype(np.int32) if ep.t == 0 else np.full(n, 2),
            ))
        return table

    def observe(self) -> dict[str, np.ndarray]:
        return {name: read(self._episode) for name, _, read in self._channel_table}

    def _get_obs(self) -> dict[str, np.ndarray]:
        """Reference-internal name (image_perception_module.py:236). reset()
        and step() dispatch through this shim so a drop-in subclass may
        override EITHER name and be honored."""
        return self.observe()

    # -- lifecycle -------------------------------------------------------------

    def seed(self, seed: int | None = None):
        """RNG chain: module rng from seed; iterator rng from a second draw
        (image_perception_module.py:105-118)."""
        from ..data.stream import DataLoader, DatasetBatchIterator

        self._rng = np.random.default_rng(seed)
        if self._loader is not None:
            self._loader.close()
        self._loader = DataLoader(
            DatasetBatchIterator(
                self._config.dataset,
                batch_size=self._num_envs,
                seed=self._rng.integers(0, 2**32 - 1, endpoint=True),
            ),
            prefetch=self._config.prefetch,
            prefetch_buffer_size=self._config.prefetch_buffer_size,
        )

    def close(self):
        if self._loader is not None:
            self._loader.close()

    def _to_device(self, pos: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pos, dtype=np.float64), device=self._device)

    def _spawn_episode(self) -> _Episode:
        """Episode draw order (the parity-pinned chain, module.py:120-161):
        batch indices from the iterator rng, then label-inversion bits, then
        start positions from the module rng."""
        cfg = self._config
        (images, labels), batch_idx = next(self._loader)
        inverted = None
        if cfg.randomly_invert_labels:
            inverted = self._rng.integers(0, 2, size=self._num_envs) == 1
            labels = np.where(inverted, cfg.dataset.num_classes - labels - 1, labels)
        if np.any(np.array(images.shape[1:3]) < self.effective_sensor_size):
            raise ValueError(
                f"Image size {tuple(images.shape[1:3])} cannot be smaller "
                f"than effective sensor size {tuple(self.effective_sensor_size)}."
            )
        pos = self._rng.uniform(-1, 1, size=(self._num_envs, 2))
        return _Episode(
            images=torch.as_tensor(np.asarray(images), device=self._device),
            labels=labels,
            batch_idx=batch_idx,
            inverted=inverted,
            pos=pos,
            pos_dev=self._to_device(pos),
            t=0,
        )

    def reset(self) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
        if self._rng is None:
            self.seed()
        self._episode = self._spawn_episode()
        obs = self._get_obs()
        if self._canvas is None:
            self._canvas = _Canvas(
                self._num_envs, self._image_size, obs["glimpse"].shape[2]
            )
        else:
            self._canvas.clear()
        self._rollover = np.zeros(self._num_envs, dtype=np.bool_)
        return obs, {"index": self._episode.batch_idx}

    # -- stepping ----------------------------------------------------------------

    def _rollover_due(self) -> bool:
        """True when EVERY env finished last step (lockstep contract); a
        partial rollover is unsupported, like the reference."""
        done = int(self._rollover.sum())
        if done and done != self._num_envs:
            raise NotImplementedError("Partial reset is not supported.")
        return bool(done)

    def _advance(self, action: np.ndarray) -> np.ndarray:
        """Swap in the moved episode snapshot; returns the action cost.
        Movement = clip(pos + max_step_length * project_sphere(action)),
        cost = -1e-3 * |action| (module.py:203-211), on the host."""
        ep = self._episode
        delta = self._max_step_length * _project_sphere(action)
        pos = np.clip(ep.pos + delta, -1, 1)
        self._episode = dataclasses.replace(ep, pos=pos, pos_dev=self._to_device(pos),
                                            t=ep.t + 1)
        return -np.linalg.norm(action, axis=-1) * 1e-3

    def step(self, action: np.ndarray, prediction_quality: np.ndarray):
        """Overlay stamp happens FIRST (at the pre-step position, with this
        step's prediction quality), then either the lockstep rollover or a
        movement step (module.py:191-217)."""
        _require_finite("prediction", prediction_quality)
        centers, stamp_wh = self._sensor_footprint()
        self._canvas.stamp(centers, stamp_wh, prediction_quality)
        if self._rollover_due():
            obs, info = self.reset()
            reward = np.zeros(self._num_envs)
            at_limit = False
        else:
            _require_finite("action", action)
            reward = self._advance(action)
            obs = self._get_obs()
            info = {"index": self._episode.batch_idx}
            at_limit = self._episode.t >= self._config.step_limit
        terminated = np.full(self._num_envs, at_limit)
        truncated = np.zeros(self._num_envs, dtype=np.bool_)
        self._rollover = terminated | truncated
        return obs, reward, terminated, truncated, info

    # -- sensing --------------------------------------------------------------

    def _sensing_points(self, pos_norm: torch.Tensor) -> torch.Tensor:
        """(..., s0, s1, 2) absolute (y, x) pixel coordinates of the sensing
        grid centered at each normalized position (module.py:294-311), on
        the device, float64."""
        s0, s1 = self._config.sensor_size
        scale = self._config.sensor_scale
        offsets = np.stack(
            np.meshgrid(
                (np.arange(s0) - (s0 - 1) / 2) * scale,
                (np.arange(s1) - (s1 - 1) / 2) * scale,
                indexing="ij",
            ),
            axis=-1,
        )
        lim = self._to_device(self.sensor_pos_lim_pixels)
        centers = torch.flip(pos_norm * lim, dims=(-1,))
        return centers[..., None, None, :] + self._to_device(offsets)[None]

    def _glimpse(self, pos_norm: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
        return _bilinear_batch(images, self._sensing_points(pos_norm)).clamp(0, 1).float()

    def get_glimpse(self, pos_norm) -> np.ndarray:
        """s0 x s1 sensing grid, bilinearly interpolated per env on the
        device, clipped to [0, 1] f32, returned as numpy. ``pos_norm``:
        numpy or a tensor, broadcastable to (N, ..., 2)."""
        if not isinstance(pos_norm, torch.Tensor):
            pos_norm = self._to_device(pos_norm)
        return self._glimpse(pos_norm, self._episode.images).cpu().numpy()

    def _candidate_grid(self) -> tuple[np.ndarray, np.ndarray]:
        """Uniform candidate lattice over normalized position space, cell
        size capped at unique_sampling_max_grid_cell_size_rel sensor sizes
        (module.py:253-267). Returns (max_cell, (P, 2) positions)."""
        cell = (
            self.normalize_coords(self.effective_sensor_size)
            * self._config.unique_sampling_max_grid_cell_size_rel
        )
        counts = np.ceil(2 / cell)
        axes = (np.linspace(-1, 1, int(c)) for c in counts)
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 2)
        return cell, grid

    def _uniqueness_scores(self, grid: np.ndarray, envs: slice = slice(None)) -> np.ndarray:
        """(N, P) float64 scores of the candidate glimpses at ``grid`` (of the
        envs in ``envs``, all by default), computed on the device in blocks
        of envs, copied to the host."""
        images = self._episode.images[envs]
        grid_dev = self._to_device(grid)[None]
        p = len(grid)
        block = max(1, _SCORE_BLOCK_BYTES // (12 * 4 * p * p))
        out = []
        for lo in range(0, len(images), block):
            glimpses = self._glimpse(grid_dev, images[lo:lo + block])
            out.append(_pairwise_uniqueness(glimpses).cpu().numpy())
        return np.concatenate(out)

    def sample_unique_glimpse_positions(self) -> np.ndarray:
        """Rank candidate positions by glimpse distinctiveness, draw one of
        the top-k per env, jitter within a grid cell (module.py:253-292).
        Draw order: selection indices, then jitter, both from the module
        rng. A pick index < top_k means ranking the full argsort and
        indexing it directly equals the reference's explicit top-k slice."""
        cfg = self._config
        cell, grid = self._candidate_grid()
        ranking = np.argsort(-self._uniqueness_scores(grid))
        pick = self._rng.integers(0, cfg.unique_sampling_top_k, size=self._num_envs)
        anchors = grid[ranking[np.arange(self._num_envs), pick]]
        jitter = self._rng.uniform(-cell, cell, (self._num_envs, 2))
        return np.clip(anchors + jitter, -1, 1)

    # -- render --------------------------------------------------------------

    def _sensor_footprint(self) -> tuple[np.ndarray, np.ndarray]:
        """Current sensor rectangles in render coordinates: (N, 2) centers
        and the (2,) stamp (width, height)."""
        centers = self.to_render_coords(self._episode.pos)
        stamp_wh = np.flip(self.effective_sensor_size * self._canvas.scaling)
        return centers, stamp_wh

    def _render_base_images(self) -> np.ndarray:
        imgs = self.current_images
        if self._channels == 1:
            return imgs[..., 0]
        if self._channels != 3:
            raise NotImplementedError()
        return imgs

    def render(self, return_pil_imgs: bool = False):
        """Per-env frame = nearest-upscaled image, optional visitation /
        quality overlay, shadowed agent rectangle — all via the shared
        compositing helpers in apx_torch.render.render."""
        import PIL.Image
        import PIL.ImageDraw

        from ..render.render import blend_overlay, outlined_box, upscale_to_rgb

        cfg = self._config
        bases = self._render_base_images()
        overlays = (
            self._canvas.overlay(
                cfg.render_visited_opacity, cfg.render_unvisited_opacity
            )
            if cfg.display_visitation
            else None
        )
        # The box half-size intentionally repeats the reference's unflipped
        # (s0, s1) order here (module.py:342-344 draws with the same
        # y/x-swapped extent it stamps flipped; visible only for non-square
        # sensors, preserved for drop-in parity).
        half = self.effective_sensor_size * self._canvas.scaling / 2
        bw = self.glimpse_border_width
        frames = []
        for i, center in enumerate(self.to_render_coords(self._episode.pos)):
            frame = upscale_to_rgb(bases[i], self._render_size)
            if overlays is not None:
                frame = PIL.Image.fromarray(
                    blend_overlay(np.asarray(frame, dtype=np.float64), overlays[i])
                )
            draw = PIL.ImageDraw.Draw(frame, "RGBA")
            outlined_box(
                draw,
                np.concatenate([center - half, center + half]),
                COLOR_AGENT,
                bw,
                shadow=True,
            )
            frames.append(frame)
        return frames if return_pil_imgs else np.asarray(frames)

    # -- coordinates ----------------------------------------------------------

    def normalize_coords(self, coords: np.ndarray) -> np.ndarray:
        return coords / self.sensor_pos_lim_pixels

    def denormalize_coords(self, coords: np.ndarray) -> np.ndarray:
        return coords * self.sensor_pos_lim_pixels

    def to_render_coords(self, pos_norm: np.ndarray) -> np.ndarray:
        return self.scale_to_render_coords(pos_norm) + np.array(self._render_size) / 2

    def scale_to_render_coords(self, size_norm: np.ndarray) -> np.ndarray:
        return self.denormalize_coords(size_norm) * self._canvas.scaling

    # -- properties -----------------------------------------------------------

    @property
    def sensor_pos_lim_pixels(self):
        """pos +-1 keeps the glimpse fully inside the image
        (image_perception_module.py:419-423)."""
        return (np.flip(np.array(self._episode.images.shape[1:3])) - 1) / 2 - (
            self.effective_sensor_size - 1
        ) / 2

    @property
    def sensor_size(self) -> tuple[int, int]:
        return self._config.sensor_size

    @property
    def image_size(self):
        return self._image_size

    @property
    def effective_sensor_size(self):
        return np.array(self._config.sensor_size) * self._config.sensor_scale

    @property
    def current_sensor_pos(self):
        return self.denormalize_coords(self._episode.pos)

    @property
    def observation_space_dict(self) -> dict:
        # One stable dict, like the reference's cached attribute
        # (image_perception_module.py:63, 448-449): callers may patch it.
        if self._observation_space_dict is None:
            self._observation_space_dict = {
                name: make() for name, make, _ in self._channel_table
            }
        return self._observation_space_dict

    @property
    def single_inner_action_space(self):
        if self._single_inner_action_space is None:
            import gymnasium as gym

            self._single_inner_action_space = gym.spaces.Box(
                -np.ones(2, dtype=np.float32), np.ones(2, dtype=np.float32)
            )
        return self._single_inner_action_space

    @property
    def config(self) -> ImagePerceptionConfig:
        return self._config

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def current_images(self) -> np.ndarray:
        return self._episode.images.cpu().numpy()

    @property
    def current_labels(self) -> np.ndarray:
        return self._episode.labels

    @property
    def glimpse_border_width(self) -> int:
        return max(1, int(round(1 / 128 * self._render_size[0])))

    @property
    def render_scaling(self):
        return None if self._canvas is None else self._canvas.scaling

    @property
    def render_size(self):
        return None if self._canvas is None else self._canvas.size

    # internal alias: properties above are the public surface; a couple of
    # private spots (and tests) want the tuple directly
    @property
    def _render_size(self):
        return self._canvas.size
