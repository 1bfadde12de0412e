"""Host-RNG shims: the reference's NumPy PCG64 draw chains (counterpart of
apx.compat.shims, numpy only).

In ``rng="reference"`` mode the adapter draws every episode-defining
random number on the host with NumPy, with the reference's generators in
the reference's order, and feeds the values to the batched device reset
and step. Both packages take the same draws, so a seeded episode is the
same numpy arrays in both.

Draw chains replicated here:
  * image envs (image_classification.py:141-149 + image_perception_module
    .py:105-161): env np_random -> module rng = default_rng(np_random.
    integers(0, 2**32, endpoint=True)); iterator rng = default_rng(
    module_rng.integers(0, 2**32 - 1, endpoint=True)); per episode:
    indices (iterator rng), label-invert bits (module rng), start pos
    (module rng); localization adds unique-target selection + jitter
    (module rng, module.py:278-289) and uniform target resample on
    autoreset from the ENV np_random (image_localization.py:152-156).
  * LightDark (light_dark.py:102-121): pos uniform + per-step obs noise,
    both from the env np_random.
  * LIDAR (lidar_localization2d.py:293-311, :547-557): map-iterator rng =
    default_rng(np_random.integers(0, 2**32, endpoint=True)) seeded at
    np_random-assignment time; per episode: map index (iterator rng,
    dynamic only; the map itself is generated host-side by index), start
    cell (env np_random, row-major over free cells).

The device touch points read the port's banks: the localization sweep's
images (``dataset.fetch``, float32 and ``/ 255`` for uint8 banks, as apx's
``fetch``) and the static map of a LIDAR bank; host maps come from the
port's ``data.floor_map`` generators.
"""

from __future__ import annotations

import numpy as np
import torch

from ..envs.image_classification import ImageClassificationEnv
from ..envs.image_localization import ImageLocalizationEnv
from ..envs.lidar_localization import LIDARLocalizationEnv
from ..envs.light_dark import LightDarkEnv

__all__ = ["make_shim", "HostShim"]


class HostShim:
    """Per-family host RNG state + draw sampling. ``num_envs`` batches every
    draw exactly like the reference's batched module draws."""

    def __init__(self, env_base, params, num_envs: int):
        self.env = env_base
        self.params = params
        self.n = num_envs

    def seed(self, np_random: np.random.Generator) -> None:
        raise NotImplementedError

    def reset_draws(self) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def step_draws(self) -> dict[str, np.ndarray] | None:
        return None

    def autoreset_draws(self) -> dict[str, np.ndarray]:
        return self.reset_draws()


class ImageShim(HostShim):
    def seed(self, np_random):
        self.np_random = np_random
        # Both bounds are 2**32 - 1 endpoint-inclusive in the reference
        # (image_classification.py:144-149, image_perception_module.py:105-112).
        module_seed = np_random.integers(0, 2**32 - 1, endpoint=True)
        self.module_rng = np.random.default_rng(module_seed)
        iter_seed = self.module_rng.integers(0, 2**32 - 1, endpoint=True)
        self.iter_rng = np.random.default_rng(iter_seed)

    def _base_draws(self):
        idx = self.iter_rng.integers(0, self.params.dataset.length, self.n)
        out = {"index": idx.astype(np.int32)}
        if self.params.randomly_invert_labels:
            out["inverted"] = self.module_rng.integers(0, 2, size=self.n) == 1
        else:
            out["inverted"] = np.zeros(self.n, dtype=bool)
        out["pos"] = self.module_rng.uniform(-1, 1, size=(self.n, 2)).astype(
            np.float32
        )
        return out


class ImageClassificationShim(ImageShim):
    def reset_draws(self):
        return self._base_draws()


class ImageLocalizationShim(ImageShim):
    def _host_unique_targets(self, indices: np.ndarray) -> np.ndarray:
        """Replicates sample_unique_glimpse_positions (module.py:253-292)
        bit-for-bit on host: scipy f64 interpolation, argsort ranking, then
        the selection + jitter draws in reference order. Parity mode only —
        the native path scores on the device (ImagePerceptionEngine). The
        images are the bank's, read as float32 (``/ 255`` for uint8)."""
        from scipy.interpolate import RegularGridInterpolator

        p = self.params
        idx = torch.as_tensor(np.asarray(indices, np.int64), device=p.device)
        images = p.dataset.fetch(idx)[0].cpu().numpy().astype(np.float32)
        n, H, W, _ = images.shape
        s0, s1 = p.sensor_size
        scale = p.sensor_scale
        eff = np.array([s0, s1]) * scale
        lim = (np.array([W, H]) - 1) / 2 - (eff - 1) / 2
        max_cell = (eff / lim) * p.unique_sampling_max_grid_cell_size_rel
        counts = np.ceil(2 / max_cell).astype(int)
        grid = np.stack(
            np.meshgrid(
                np.linspace(-1, 1, counts[0]),
                np.linspace(-1, 1, counts[1]),
                indexing="ij",
            ),
            axis=-1,
        ).reshape(-1, 2)
        offs = np.stack(
            np.meshgrid(
                (np.arange(s0) - (s0 - 1) / 2) * scale,
                (np.arange(s1) - (s1 - 1) / 2) * scale,
                indexing="ij",
            ),
            axis=-1,
        )
        coords_y = np.arange(H) - (H - 1) / 2
        coords_x = np.arange(W) - (W - 1) / 2
        # Sensing points for every candidate: (P, s0, s1, 2) in (y, x).
        pts = np.flip(grid * lim, axis=-1)[:, None, None, :] + offs[None]
        top_k = np.empty((n, p.unique_sampling_top_k), dtype=np.int64)
        for i in range(n):
            rgi = RegularGridInterpolator(
                (coords_y, coords_x), images[i], method="linear"
            )
            glimpses = rgi(pts).clip(0, 1).astype(np.float32)
            diff = np.mean(
                (glimpses[None] - glimpses[:, None]) ** 2, axis=(-3, -2, -1)
            )
            uniq = np.min(diff + np.diag(np.full(len(grid), np.inf)), axis=-1)
            top_k[i] = np.argsort(-uniq)[: p.unique_sampling_top_k]
        sel = self.module_rng.integers(0, p.unique_sampling_top_k, size=self.n)
        base = grid[top_k[np.arange(self.n), sel]]
        jitter = self.module_rng.uniform(-max_cell, max_cell, (self.n, 2))
        return np.clip(base + jitter, -1, 1).astype(np.float32)

    def reset_draws(self):
        d = self._base_draws()
        d["target"] = self._host_unique_targets(d["index"])
        return d

    def autoreset_draws(self):
        # On autoreset the target is resampled uniformly from the ENV
        # np_random BEFORE the module's reset draws happen
        # (image_localization.py:152-156 runs before module.step -> reset).
        target = self.np_random.uniform(-1, 1, (self.n, 2)).astype(np.float32)
        d = self._base_draws()
        d["target"] = target
        return d


class LightDarkShim(HostShim):
    def seed(self, np_random):
        self.np_random = np_random
        self.rngs = None

    def seed_vector(self, np_randoms):
        """Per-sub-env generators, as under the reference's SyncVectorEnv
        (each sub-env i is seeded seed+i and draws independently)."""
        self.rngs = list(np_randoms)
        self.np_random = self.rngs[0]

    def _reset_one(self, rng):
        pos = rng.uniform(-np.ones(2), np.ones(2), size=2).astype(np.float32)
        noise = rng.normal(size=2).astype(np.float32)
        return pos, noise

    def reset_draws(self):
        rngs = self.rngs or [self.np_random] * self.n
        pos, noise = zip(*(self._reset_one(r) for r in rngs[: self.n]))
        return {"pos": np.stack(pos), "noise": np.stack(noise)}

    def step_draws(self):
        rngs = self.rngs or [self.np_random] * self.n
        noise = np.stack(
            [r.normal(size=2).astype(np.float32) for r in rngs[: self.n]]
        )
        return {"noise": noise}

    def vector_draws(self, prev_done):
        """Per-env conditional draws for NEXT_STEP autoreset: a resetting
        env consumes (pos, noise) from ITS stream; a stepping env consumes
        only its obs noise (light_dark.py:102-121). Dummy zeros fill the
        untaken branch so shapes stay static."""
        assert self.rngs is not None
        step_noise = np.zeros((self.n, 2), np.float32)
        reset_pos = np.zeros((self.n, 2), np.float32)
        reset_noise = np.zeros((self.n, 2), np.float32)
        for i, rng in enumerate(self.rngs):
            if prev_done[i]:
                reset_pos[i], reset_noise[i] = self._reset_one(rng)
            else:
                step_noise[i] = rng.normal(size=2).astype(np.float32)
        return {"noise": step_noise}, {"pos": reset_pos, "noise": reset_noise}


class LIDARShim(HostShim):
    def _host_static(self):
        """The static map and its dataset index, read from the bank once."""
        bank, k = self.params.map_bank, self.params.static_map_pos
        return bank.maps[k].cpu().numpy(), int(bank.indices[k].item())

    def seed(self, np_random):
        self.np_random = np_random
        self.rngs = None
        if not self.params.static_map:
            seed = np_random.integers(0, 2**32, endpoint=True)
            self.map_rng = np.random.default_rng(seed)
            self.map_rngs = None
        self._static = self._host_static() if self.params.static_map else None

    def seed_vector(self, np_randoms):
        self.rngs = list(np_randoms)
        self.np_random = self.rngs[0]
        self._static = self._host_static() if self.params.static_map else None
        if not self.params.static_map:
            self.map_rngs = [
                np.random.default_rng(r.integers(0, 2**32, endpoint=True))
                for r in self.rngs
            ]

    def _reset_one(self, rng, map_rng):
        if self.params.static_map:
            occ, idx = self._static
        else:
            idx = int(map_rng.integers(0, 2**32))
            occ = self._generate_map(idx)
        free_y, free_x = np.where(~occ)
        k = rng.integers(0, len(free_y))
        pos = np.array([free_x[k], free_y[k]], dtype=np.float32) + 0.5
        return occ, pos, idx

    def vector_draws(self, prev_done):
        assert self.rngs is not None
        h, w = self.params.map_bank.map_hw
        occs = np.zeros((self.n, h, w), bool)
        poss = np.zeros((self.n, 2), np.float32)
        idxs = np.zeros(self.n, np.uint32)
        for i, rng in enumerate(self.rngs):
            if prev_done[i]:
                mr = self.map_rngs[i] if not self.params.static_map else None
                occs[i], poss[i], idxs[i] = self._reset_one(rng, mr)
        return None, {"occ": occs, "pos": poss, "map_idx": idxs}

    def _generate_map(self, idx: int) -> np.ndarray:
        from ..data.floor_map import generate_maze_map, generate_rooms_map

        h, w = self.params.map_bank.map_hw
        kind = self.params.map_bank.kind
        if kind == "maze":
            return generate_maze_map(idx, w, h)
        if kind == "rooms":
            return generate_rooms_map(idx, w, h)
        raise ValueError(
            f"cannot regenerate maps for a {kind!r} bank in parity mode — "
            "build the bank with make_maze_bank/make_rooms_bank or use "
            "static_map=True"
        )

    def reset_draws(self):
        occs, poss, idxs = [], [], []
        for i in range(self.n):
            if self.rngs is not None:
                rng = self.rngs[i]
                map_rng = None if self.params.static_map else self.map_rngs[i]
            else:
                rng = self.np_random
                map_rng = None if self.params.static_map else self.map_rng
            occ, pos, idx = self._reset_one(rng, map_rng)
            occs.append(occ)
            poss.append(pos)
            idxs.append(idx)
        return {
            "occ": np.stack(occs),
            "pos": np.stack(poss),
            "map_idx": np.asarray(idxs, np.uint32),
        }


_SHIMS = {
    ImageClassificationEnv: ImageClassificationShim,
    ImageLocalizationEnv: ImageLocalizationShim,
    LightDarkEnv: LightDarkShim,
    LIDARLocalizationEnv: LIDARShim,
}


def make_shim(env_base, params, num_envs: int) -> HostShim | None:
    cls = _SHIMS.get(type(env_base))
    if cls is None:
        return None
    return cls(env_base, params, num_envs)
