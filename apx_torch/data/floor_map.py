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
from typing import Any

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
    "BEAM_SIGNS",
    "build_beam_tables",
    "unpack_words",
    "halves_of_words",
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
    the same, < 2**32).

    A bank sharded across ranks (``distrib.shard_params(...,
    shard_leading=True)``) holds this rank's block of every leaf with a
    leading bank axis and a ``shard`` (``distrib.mesh.BankShard``); its
    reads (``fetch``, ``fetch_halves``, ``spawn``, ``free_count``) are then
    collectives that every rank makes together. The beam tables stay
    whole."""

    maps: torch.Tensor  # (M, H, W) bool
    indices: torch.Tensor  # (M,) int64 — dataset index of each map (uint32 range)
    free_counts: torch.Tensor  # (M,) int64 — free cells per map
    row_words: torch.Tensor  # (M, H) int64 — packed rows (W <= 32)
    # (M, max_free) int64: row-major flat indices of each map's free cells,
    # 0-padded past free_counts[m] — the spawn draw's "k-th free cell".
    free_cells: torch.Tensor
    kind: str = "custom"
    # Optional beam face tables (``with_beam_tables``): (M, 8, 2, H, W)
    # float32 faces and bool axes, for the table observation scan.
    beam_face: torch.Tensor | None = None
    beam_axis: torch.Tensor | None = None
    shard: Any = dataclasses.field(default=None, compare=False)

    def with_beam_tables(self) -> "MapBank":
        """The bank with the first-wall face tables of the 8 default beam
        directions (``build_beam_tables``, a host numpy build)."""
        face, axis_x = build_beam_tables(self.maps.cpu().numpy())
        return dataclasses.replace(self, beam_face=torch.from_numpy(face).to(self.device),
                                   beam_axis=torch.from_numpy(axis_x).to(self.device))

    @property
    def num_maps(self) -> int:
        return self.shard.num_rows if self.shard is not None else int(self.maps.shape[0])

    def _take(self, bank_idx: torch.Tensor, *leaves) -> list[torch.Tensor]:
        """``leaf[bank_idx]`` (or ``leaf[bank_idx, col]`` for a (leaf, col)
        pair) of each leaf; on a sharded bank one collective for all."""
        pairs = [x if isinstance(x, tuple) else (x, None) for x in leaves]
        if self.shard is not None:
            return self.shard.take(bank_idx, pairs)
        return [leaf[bank_idx] if col is None else leaf[bank_idx, col] for leaf, col in pairs]

    def free_count(self, bank_idx: torch.Tensor) -> torch.Tensor:
        """Free cells of the maps at ``bank_idx``."""
        return self._take(bank_idx, self.free_counts)[0]

    def spawn(self, bank_idx: torch.Tensor,
              k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """What a reset reads of the bank, in one fetch: the row words (...,
        H) of the maps at ``bank_idx``, the row-major index of each map's
        ``k``-th free cell and the maps' dataset indices."""
        words, flat, index = self._take(bank_idx, self.row_words, (self.free_cells, k),
                                        self.indices)
        return words, flat, index

    def sharded(self, shard, block, whole) -> "MapBank":
        """This rank's block [shard.lo, shard.hi) of every leaf with a
        leading bank axis, ``block(leaf)``, with ``shard`` set; the beam
        tables stay whole, ``whole(leaf)`` (``distrib.shard_params`` places
        both on the rank's device)."""
        tables = {f: None if getattr(self, f) is None else whole(getattr(self, f))
                  for f in ("beam_face", "beam_axis")}
        return dataclasses.replace(
            self, **{f: block(getattr(self, f)) for f in
                     ("maps", "indices", "free_counts", "row_words", "free_cells")},
            **tables, shard=shard)

    @property
    def map_hw(self) -> tuple[int, int]:
        return (int(self.maps.shape[1]), int(self.maps.shape[2]))

    @property
    def device(self) -> torch.device:
        return self.maps.device

    def fetch(self, bank_idx: torch.Tensor) -> torch.Tensor:
        """(..., H, W) bool maps at bank positions ``bank_idx``."""
        return unpack_words(self._take(bank_idx, self.row_words)[0], self.map_hw[1])

    def fetch_halves(self, bank_idx: torch.Tensor) -> torch.Tensor:
        """(..., H, 2) int32: each fetched row's occupancy bits as two
        little-endian 16-bit half-words, ``words & 0xFFFF`` and ``words >>
        16``, bitwise apx's ``MapBank.fetch_halves``: what the bitslab
        raycast backends window from."""
        return halves_of_words(self._take(bank_idx, self.row_words)[0])


def unpack_words(words: torch.Tensor, w: int) -> torch.Tensor:
    """(..., H, W) bool maps of row words (..., H): bit x of word y is cell
    (y, x)."""
    shifts = torch.arange(w, dtype=torch.int64, device=words.device)
    return ((words[..., None] >> shifts) & 1) == 1


def halves_of_words(words: torch.Tensor) -> torch.Tensor:
    """(..., H, 2) int32 half-words ``words & 0xFFFF``, ``words >> 16`` of
    row words (..., H)."""
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


# ---------------------------------------------------------------------------
# Beam face tables (apx's, copied): per map cell and per default beam
# direction, the coordinate of the first wall face the beam crosses, so the
# observation scan is one lookup per beam (``ops.raycast.lidar_table_scan``).

# Integer direction (sx, sy) of the beams at angles linspace(-pi, pi, 8,
# endpoint=False): 0:-x, 1:(-x,-y), 2:-y, 3:(+x,-y), 4:+x, 5:(+x,+y),
# 6:+y, 7:(-x,+y).
BEAM_SIGNS = np.array(
    [(-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1)],
    dtype=np.int32,
)
_MISS = 1.0e6  # face sentinel: t becomes huge and positive, a miss


def _axis_face_tables(occ: np.ndarray) -> dict:
    """(M, H, W) first-wall face coordinate along each axis direction."""
    h, w = occ.shape[1:]
    col = np.arange(w)[None, None, :]
    row = np.arange(h)[None, :, None]
    big = np.full_like(occ, _MISS, dtype=np.float64)

    # +x: the nearest wall column > cx; its near face is the column.
    px = np.flip(np.minimum.accumulate(np.flip(np.where(occ, col, _MISS).astype(np.float64),
                                               -1), -1), -1)
    face_px = np.concatenate([px[..., 1:], big[..., :1]], axis=-1)
    # -x: the nearest wall column < cx; its near face is column + 1.
    nx_ = np.maximum.accumulate(np.where(occ, col, -_MISS).astype(np.float64), -1)
    face_nx = np.concatenate([-big[..., :1], nx_[..., :-1] + 1.0], axis=-1)
    face_nx = np.where(face_nx < -_MISS / 2, -_MISS, face_nx)
    # +y / -y over rows.
    py = np.flip(np.minimum.accumulate(np.flip(np.where(occ, row, _MISS).astype(np.float64),
                                               -2), -2), -2)
    face_py = np.concatenate([py[..., 1:, :], big[..., :1, :]], axis=-2)
    ny_ = np.maximum.accumulate(np.where(occ, row, -_MISS).astype(np.float64), -2)
    face_ny = np.concatenate([-big[..., :1, :], ny_[..., :-1, :] + 1.0], axis=-2)
    face_ny = np.where(face_ny < -_MISS / 2, -_MISS, face_ny)
    return {(1, 0): face_px, (-1, 0): face_nx, (0, 1): face_py, (0, -1): face_ny}


def _diag_face_tables(occ: np.ndarray, sx: int, sy: int):
    """The exact 45-degree staircase walk from every cell: per variant (0 =
    x crossing first, 1 = y crossing first) the first wall face and whether
    it is an x face. |dx| == |dy|, so the crossings alternate and the walk
    from a cell depends only on which comes first."""
    m, h, w = occ.shape
    faces = np.empty((2, m, h, w), dtype=np.float64)
    axes_x = np.empty((2, m, h, w), dtype=bool)
    midx = np.arange(m)[:, None, None]
    for v in range(2):
        cx = np.broadcast_to(np.arange(w)[None, None, :], (m, h, w)).copy()
        cy = np.broadcast_to(np.arange(h)[None, :, None], (m, h, w)).copy()
        face = np.full((m, h, w), _MISS * (sx if sx else 1), dtype=np.float64)
        ax_x = np.ones((m, h, w), dtype=bool)
        done = np.zeros((m, h, w), dtype=bool)
        for k in range(2 * (h + w)):
            if (k % 2 == 0) == (v == 0):  # an x crossing
                nxt = cx + sx
                oob = (nxt < 0) | (nxt >= w)
                hit = np.zeros_like(done)
                live = ~done & ~oob
                hit[live] = occ[midx, cy, np.clip(nxt, 0, w - 1)][live]
                newly = ~done & hit
                face[newly] = (nxt + (0 if sx > 0 else 1))[newly]
                ax_x[newly] = True
                done |= newly | (~done & oob)
                cx = np.where(done, cx, nxt)
            else:
                nyt = cy + sy
                oob = (nyt < 0) | (nyt >= h)
                hit = np.zeros_like(done)
                live = ~done & ~oob
                hit[live] = occ[midx, np.clip(nyt, 0, h - 1), cx][live]
                newly = ~done & hit
                face[newly] = (nyt + (0 if sy > 0 else 1))[newly]
                ax_x[newly] = False
                done |= newly | (~done & oob)
                cy = np.where(done, cy, nyt)
            if done.all():
                break
        # A miss keeps the sentinel, signed as the x direction so that
        # t = (face - p) * inv is huge and positive.
        miss = ~done | (np.abs(face) >= _MISS / 2)
        face[miss] = _MISS * (1 if sx > 0 else -1)
        ax_x[miss] = True
        faces[v] = face
        axes_x[v] = ax_x
    return faces, axes_x


def build_beam_tables(maps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(face, axis_x) of shape (M, 8, 2, H, W): face is the first wall face
    coordinate of beam b from cell (cy, cx) under staircase variant v (axis
    beams ignore v), float32; axis_x whether it is an x = const face."""
    occ = np.asarray(maps, dtype=bool)
    m, h, w = occ.shape
    axis_tables = _axis_face_tables(occ)
    face = np.empty((m, 8, 2, h, w), dtype=np.float32)
    axis_x = np.empty((m, 8, 2, h, w), dtype=bool)
    for b, (sx, sy) in enumerate(BEAM_SIGNS):
        if sx == 0 or sy == 0:
            face[:, b, 0] = face[:, b, 1] = axis_tables[(int(sx), int(sy))].astype(np.float32)
            axis_x[:, b, :] = sy == 0  # x faces for the x-axis beams
        else:
            f, ax = _diag_face_tables(occ, int(sx), int(sy))
            face[:, b] = f.transpose(1, 0, 2, 3).astype(np.float32)
            axis_x[:, b] = ax.transpose(1, 0, 2, 3)
    return face, axis_x
