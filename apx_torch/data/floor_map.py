"""Procedural floor maps (maze / rooms) and device map banks (counterpart
of apx.data.floor_map).

The generators are numpy copies of apx's, draw for draw, so bank[i] is
bitwise the map apx (and the reference ap_gym dataset) makes for index i.
Maps are boolean occupancy grids, True = wall; wall cell (row y, col x)
spans [x, x+1] x [y, y+1].

Banks come from the Python generators (``backend="python"``, the
default) or from the port's copy of apx's C++ generator
(``backend="native"``, ``data/native.py``; ``"auto"`` picks it when it
builds): the same map family, other maps per index, bitwise apx's native
maps.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .native import generate_maze_bank_native, generate_rooms_bank_native, native_available

__all__ = [
    "generate_maze_map",
    "generate_rooms_map",
    "MapBank",
    "make_maze_bank",
    "make_rooms_bank",
    "bank_from_maps",
    "pack_rows",
]


def generate_maze_map(
    idx: int, width: int = 21, height: int = 21, branching_prob: float = 1.0
) -> np.ndarray:
    """(H, W) bool maze, True = wall: a recursive backtracker seeded by
    ``np.random.default_rng(idx)`` (one ``permutation`` per carve visit,
    one ``random()`` per eligible non-first branch)."""
    if width % 2 == 0 or height % 2 == 0:
        raise ValueError("maze width/height must be odd")
    rng = np.random.default_rng(int(idx))
    occ = np.ones((height, width), dtype=np.bool_)
    dirs = np.array([[2, 0], [-2, 0], [0, 2], [0, -2]])

    limit_needed = width * height + 100
    if sys.getrecursionlimit() < limit_needed:
        sys.setrecursionlimit(limit_needed)

    def visit(x: int, y: int) -> None:
        carved_here = False
        for dx, dy in rng.permutation(dirs):
            nx, ny = x + dx, y + dy
            if 0 < nx < width - 1 and 0 < ny < height - 1 and occ[ny, nx]:
                if not carved_here or rng.random() < branching_prob:
                    occ[y + dy // 2, x + dx // 2] = False
                    occ[ny, nx] = False
                    visit(nx, ny)
                    carved_here = True

    occ[1, 1] = False
    visit(1, 1)
    return occ


def _partition_sizes(total: int, parts: int, rng: np.random.Generator) -> np.ndarray:
    """Split ``total`` into ``parts`` non-negative integers summing to it,
    via sorted distinct cut points."""
    candidates = np.arange(1, total)
    candidates = np.concatenate(
        [np.zeros(max(0, parts - total), dtype=np.int_), candidates]
    )
    cuts = np.sort(rng.choice(candidates, parts - 1, replace=False))
    return np.diff(np.concatenate(([0], cuts, [total])))


def generate_rooms_map(
    idx: int,
    width: int = 32,
    height: int = 32,
    max_rooms: int = 10,
    door_width: int = 3,
) -> np.ndarray:
    """(H, W) bool rooms map, True = wall: recursive room splitting with
    ``door_width``-wide doors and a final coin-flip transpose, seeded by
    ``np.random.default_rng(idx)``. Working values: 1 = wall, -1 = door
    (protected from later wall passes), 0 = free."""
    if width != height:
        raise ValueError("rooms maps must be square (width == height); "
                         f"got {width}x{height}")
    rng = np.random.default_rng(int(idx))
    min_room = door_width + 2
    grid = np.zeros((height, width), dtype=np.int8)
    grid[0, :] = grid[-1, :] = 1
    grid[:, 0] = grid[:, -1] = 1

    def split(region: np.ndarray, budget: int) -> None:
        # region is a (possibly transposed) view into grid; splits happen
        # along its first axis, then recurse transposed (alternating cuts).
        cap = min(budget, (region.shape[0] - min_room) // (min_room + 1) + 1)
        if cap <= 1:
            return
        n_sub = rng.binomial(cap - 2, 0.3) + 2
        sub_budget = _partition_sizes(cap, n_sub, rng)
        sizes = (
            _partition_sizes(region.shape[0] - n_sub * (1 + min_room) + 1, n_sub, rng)
            + min_room
        )
        ends = np.cumsum(sizes + 1) - 1
        starts = np.concatenate(([0], ends[:-1] + 2))
        walls = starts[1:] - 1
        doors = rng.integers(0, region.shape[1] - door_width, size=n_sub - 1)
        span = np.arange(door_width)

        region[walls] = np.where(region[walls] != -1, 1, -1)
        rows_fwd = walls[:, None, None] + span[None, :, None]
        rows_bwd = walls[:, None, None] - span[None, :, None]
        cols = doors[:, None, None] + span[None, None, :]
        region[rows_fwd, cols] = -1
        region[rows_bwd, cols] = -1

        for s, e, b in zip(starts, ends, sub_budget):
            split(region[s : e + 1].T, b)

    split(grid[1:-1, 1:-1], max_rooms)
    grid[grid == -1] = 0
    if rng.integers(0, 2) == 0:
        grid = grid.T
    return grid.astype(np.bool_)


@dataclasses.dataclass(frozen=True)
class MapBank:
    """Device-resident bank of occupancy maps.

    ``row_words`` holds each map row's bits (bit x of word y = maps[m, y, x])
    and ``fetch`` unpacks THOSE, as apx does. apx keeps them as uint32;
    torch has no shifts on uint32, so they are int64 here (the values are
    the same, < 2**32)."""

    maps: torch.Tensor  # (M, H, W) bool
    indices: torch.Tensor  # (M,) int64 — dataset index of each map (uint32 range)
    free_counts: torch.Tensor  # (M,) int64 — free cells per map
    row_words: torch.Tensor  # (M, H) int64 — packed rows (W <= 32)
    # (M, max_free) int64: row-major flat indices of each map's free cells,
    # 0-padded past free_counts[m] — the spawn draw's "k-th free cell".
    free_cells: torch.Tensor
    kind: str = "custom"

    @property
    def num_maps(self) -> int:
        return int(self.maps.shape[0])

    @property
    def map_hw(self) -> tuple[int, int]:
        return (int(self.maps.shape[1]), int(self.maps.shape[2]))

    @property
    def device(self) -> torch.device:
        return self.maps.device

    def fetch(self, bank_idx: torch.Tensor) -> torch.Tensor:
        """(..., H, W) bool maps at bank positions ``bank_idx``."""
        _, w = self.map_hw
        words = self.row_words[bank_idx]  # (..., H)
        shifts = torch.arange(w, dtype=torch.int64, device=words.device)
        return ((words[..., None] >> shifts) & 1) == 1

    def fetch_halves(self, bank_idx: torch.Tensor) -> torch.Tensor:
        """(..., H, 2) int32: each fetched row's occupancy bits as two
        little-endian 16-bit half-words, ``words & 0xFFFF`` and ``words >>
        16``, bitwise apx's ``MapBank.fetch_halves``. (apx's bitslab raycast
        backends window from these; the port has none yet.)"""
        words = self.row_words[bank_idx]  # (..., H)
        return torch.stack([words & 0xFFFF, words >> 16], dim=-1).to(torch.int32)


def pack_rows(maps: np.ndarray) -> np.ndarray:
    """(M, H) int64 row words of (M, H, W) bool maps: bit x of word y is
    maps[m, y, x]."""
    w = maps.shape[2]
    if w > 32:
        raise ValueError(f"packed map rows need W <= 32, got {w}")
    return (maps.astype(np.int64) << np.arange(w, dtype=np.int64)).sum(axis=-1)


def bank_from_maps(maps: np.ndarray, indices: np.ndarray, kind: str, device) -> MapBank:
    """MapBank with the packed rows and free-cell table derived from
    ``maps`` (M, H, W) bool, as apx's ``_make_bank`` derives them."""
    maps = np.asarray(maps, dtype=np.bool_)
    m = maps.shape[0]
    free = (~maps).reshape(m, -1).sum(axis=-1).astype(np.int64)
    row_words = pack_rows(maps)
    max_free = int(free.max()) if m else 0
    free_cells = np.zeros((m, max_free), np.int64)
    for i in range(m):
        idxs = np.flatnonzero(~maps[i].reshape(-1))
        free_cells[i, : len(idxs)] = idxs
    return MapBank(
        maps=torch.from_numpy(maps).to(device),
        indices=torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(device),
        free_counts=torch.from_numpy(free).to(device),
        row_words=torch.from_numpy(row_words).to(device),
        free_cells=torch.from_numpy(free_cells).to(device),
        kind=kind,
    )


def _make_bank(gen, num_maps: int, seed: int | None, explicit_indices, native_gen,
               backend: str, kind: str, device) -> MapBank:
    if explicit_indices is not None:
        indices = np.asarray(explicit_indices, dtype=np.uint64)
    elif seed is None:
        indices = np.arange(num_maps, dtype=np.uint64)
    else:
        # apx's i.i.d. index draws with a dedicated bank seed.
        indices = np.random.default_rng(seed).integers(
            0, 2**32, size=num_maps, endpoint=True, dtype=np.uint64
        )
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown backend {backend!r}")
    use_native = False
    if backend in ("auto", "native"):
        use_native = native_available()
        if backend == "native" and not use_native:
            raise RuntimeError("native map generator unavailable")
    maps = native_gen(indices) if use_native else np.stack([gen(int(i)) for i in indices])
    # The recorded identity narrows to uint32 as in apx (the 2**32 edge
    # value wraps to 0 there too).
    return bank_from_maps(maps, indices.astype(np.uint32), kind, device)


def make_maze_bank(
    num_maps: int = 256,
    width: int = 21,
    height: int = 21,
    branching_prob: float = 1.0,
    seed: int | None = 0,
    indices=None,
    backend: str = "python",
    device="cuda",
) -> MapBank:
    """backend="python" (default) matches the reference's NumPy draws
    bitwise; "native" uses the C++ generator (same map family, different
    per-index maps, bitwise apx's native ones); "auto" is native where it
    builds."""
    return _make_bank(
        lambda i: generate_maze_map(i, width, height, branching_prob),
        num_maps, seed, indices,
        lambda idx: generate_maze_bank_native(idx, width, height, branching_prob),
        backend, "maze", device,
    )


def make_rooms_bank(
    num_maps: int = 256,
    width: int = 32,
    height: int = 32,
    max_rooms: int = 10,
    door_width: int = 3,
    seed: int | None = 0,
    indices=None,
    backend: str = "python",
    device="cuda",
) -> MapBank:
    if width != height:
        raise ValueError("rooms maps must be square (width == height); "
                         f"got {width}x{height}")
    return _make_bank(
        lambda i: generate_rooms_map(i, width, height, max_rooms, door_width),
        num_maps, seed, indices,
        lambda idx: generate_rooms_bank_native(idx, width, height, max_rooms, door_width),
        backend, "rooms", device,
    )
