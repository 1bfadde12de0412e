"""The rooms maps of LIDARLocRooms-v0, made by the benchmark from the seed:
a frozen copy of ap_gym's rooms generator as the port carries it
(``apx_torch/data/floor_map.py`` ``generate_rooms_map``), so that the
benchmark, not the program, makes the maps that both the program and the
reference read."""

from __future__ import annotations

import numpy as np

__all__ = ["rooms_map", "rooms_bank"]


def _partition_sizes(total: int, parts: int, rng: np.random.Generator) -> np.ndarray:
    candidates = np.arange(1, total)
    candidates = np.concatenate([np.zeros(max(0, parts - total), dtype=np.int_), candidates])
    cuts = np.sort(rng.choice(candidates, parts - 1, replace=False))
    return np.diff(np.concatenate(([0], cuts, [total])))


def rooms_map(idx: int, size: int = 32, max_rooms: int = 10, door_width: int = 3) -> np.ndarray:
    """(size, size) bool map, True = wall: recursive room splitting with
    ``door_width``-wide doors and a final coin-flip transpose, seeded by
    ``np.random.default_rng(idx)``."""
    rng = np.random.default_rng(int(idx))
    min_room = door_width + 2
    grid = np.zeros((size, size), dtype=np.int8)
    grid[0, :] = grid[-1, :] = 1
    grid[:, 0] = grid[:, -1] = 1

    def split(region: np.ndarray, budget: int) -> None:
        cap = min(budget, (region.shape[0] - min_room) // (min_room + 1) + 1)
        if cap <= 1:
            return
        n_sub = rng.binomial(cap - 2, 0.3) + 2
        sub_budget = _partition_sizes(cap, n_sub, rng)
        sizes = (_partition_sizes(region.shape[0] - n_sub * (1 + min_room) + 1, n_sub, rng)
                 + min_room)
        ends = np.cumsum(sizes + 1) - 1
        starts = np.concatenate(([0], ends[:-1] + 2))
        walls = starts[1:] - 1
        doors = rng.integers(0, region.shape[1] - door_width, size=n_sub - 1)
        span = np.arange(door_width)
        region[walls] = np.where(region[walls] != -1, 1, -1)
        cols = doors[:, None, None] + span[None, None, :]
        region[walls[:, None, None] + span[None, :, None], cols] = -1
        region[walls[:, None, None] - span[None, :, None], cols] = -1
        for s, e, b in zip(starts, ends, sub_budget):
            split(region[s:e + 1].T, b)

    split(grid[1:-1, 1:-1], max_rooms)
    grid[grid == -1] = 0
    if rng.integers(0, 2) == 0:
        grid = grid.T
    return grid.astype(np.bool_)


def rooms_bank(seed: int, num_maps: int, size: int = 32, max_rooms: int = 10,
               door_width: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """(maps (M, size, size) bool, dataset indices (M,) int64): the indices
    drawn i.i.d. from [0, 2**32] by ``np.random.default_rng(seed)``, map i
    generated from index i."""
    indices = np.random.default_rng(seed).integers(0, 2**32, size=num_maps, endpoint=True,
                                                   dtype=np.uint64)
    maps = np.stack([rooms_map(int(i), size, max_rooms, door_width) for i in indices])
    return maps, indices.astype(np.uint32).astype(np.int64)
