"""2D LIDAR localization environment, batched over envs (counterpart of
apx.envs.lidar_localization).

Same semantics as apx's env (its module docstring lists the reference
behaviours kept): 8 beams of range 5 with lidar obs = clip(dist / range),
odometry = (pos - initial_pos) / [W, H], the dynamic-map obs occ / 255,
base reward 0.1 - 1e-3 |a|^2, the move-to-wall cast and the reference's
wall slide with its quirks, out-of-map termination, the previous position
as the prediction target, spawns uniform over free cells, and a fresh
bank map per episode.

Every backend of apx's ``raycast_backend`` switch is ported, with apx's
meaning, and the env carries the same state leaves as apx's but for the
ray-padded map (below):

* ``"auto"`` (the default) and its alias ``"xla"``: every cast on the
  whole map: the step's movement cast (1 ray), wall-slide cast (2 rays)
  and beam scan with the step's arithmetic as one launch of kernel S, and
  the reset (the map unpacked from the bank's row words, the spawn
  position, the GEOS-typed scan and the observation) as one launch of
  kernel R (``apx_torch.ops.lidar_fused_cuda``; both cast with K1's code).
  apx's ``"auto"`` resolves to ``"bitslab2d"``, whose casts are bitwise
  these (pinned in apx's tests/test_lidar.py), so the port's ``"auto"``
  env equals apx's. Whether the card should resolve it otherwise is left
  to the A/B numbers (PERF.md).
* ``"bitslab2d"`` / ``"bitslab"``: the step's casts run on a 16x16 (or
  Hx16) window cut from the map's rows packed into 16-bit half-words
  (``row_halves``, a state leaf packed at reset), with the lattice in map
  coordinates: bitwise the dense casts. The casts of a 2-D window take
  apx's static rho slice, and with ``beam_rects="on"`` the beams take
  their static per-ray rectangles. These are apx's XLA forms, plain
  PyTorch on the card; the GEOS-typed reset scan stays dense, in R.
* ``"windowed"``: each cast runs K1 on the (2 radius + 2)^2 window around
  its own origin, in the window frame (radius 2 for the moves, ``ray_pad``
  for the scans); ``"hybrid"``: the moves so, the scans on the whole map.
* ``"mxu_window"``: one 16x16 window per step (and per reset) around the
  pre-move position, by one-hot products; every cast runs K1 on it.
* ``"pallas_window"``: K2 (``apx_torch.ops.window_cuda``) cuts one (24, 16)
  window per env around the step's pre-move position, and the step's three
  casts run K1 on it; the reset cuts its own window for the typed scan.
* ``"pallas"``: every cast, the reset scan included, is K1's untyped
  cast on the whole map (S, and R's untyped form): apx's Pallas backend
  skips the GEOS typing at reset.

The reset is R wherever its scan runs on the whole map (every backend but
the window-frame ones: ``"windowed"``, ``"mxu_window"``, ``"pallas_window"``
where their windows fit), the step S wherever all three casts do (the
dense backends without the beam tables); elsewhere K1 casts, with F1's
four stages (``apx_torch.ops.lidar_step_cuda``) around the step's casts.
R reads the bank itself unless the bank is sharded or the row halves are
carried. Under NEXT_STEP the vector env's autoreset names the envs that
were done (``autoreset_from_draws``'s ``only``), and R computes those
alone.

The window-frame backends round at other sites than the dense path, so
each equals apx's env under the same backend (bitwise), and the dense one
to the tolerances apx pins between its forms. ``use_beam_tables=True``
(with a bank from ``MapBank.with_beam_tables``) takes the step's beam
scan from the face tables, one lookup per beam.

apx's window backends carry the ray-padded map, (N, H + 2 pad, W + 2 pad),
as a state leaf; the port does not: the windows are cut from ``occ``
itself (the padding is zeros), with cells outside the map reading 0.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from ..core.env import APEnv, APStepResult
from ..core.losses import LossFn
from ..core.numerics import div, fma
from ..core.spaces import Box, DictSpace, Image, Space
from ..data.floor_map import BEAM_SIGNS, MapBank, halves_of_words
from ..ops import lidar_fused_cuda, lidar_step, lidar_step_cuda
from ..ops.lidar_fused import reset_observation, spawn_leaves
from ..ops.raycast import (beam_cell_rects, bitslab_window, bitslab_window_2d,
                           extract_window_mxu, lidar_directions_np, lidar_table_scan,
                           raycast_grid_bitslab, raycast_grid_bitslab2d,
                           raycast_grid_bitslab2d_per_ray, windowed_window)
from ..ops.raycast_cuda import raycast_fast, raycast_typed
from ..ops.window import WIN, window_starts
from ..ops.window_cuda import extract_windows
from .common import make_regression_loss_and_target_space

__all__ = ["LIDARLocalizationEnv", "LIDARLocalizationParams", "LIDARLocalizationState",
           "LIDARBitslabState", "BitWindow", "RAYCAST_BACKENDS"]

RAYCAST_BACKENDS = ("auto", "xla", "bitslab2d", "bitslab", "windowed", "hybrid", "mxu_window",
                    "pallas_window", "pallas")
# The window radius (and the bit windows' reach) of the step's move and
# wall-slide candidate casts: their segments are at most 1 long.
MOVE_RADIUS = 2


@dataclasses.dataclass(frozen=True, eq=False)
class LIDARLocalizationParams:
    map_bank: MapBank
    static_map: bool = False
    static_map_pos: int = 0
    lidar_beam_count: int = 8
    lidar_range: float = 5.0
    # apx's raycast backend switch (RAYCAST_BACKENDS; see the module
    # docstring). "auto" is the dense casts here.
    raycast_backend: str = "auto"
    # The step's beam scan from the bank's face tables (a bank built with
    # MapBank.with_beam_tables, 8 beams); inactive otherwise, as in apx.
    use_beam_tables: bool = False
    # "on": the beams of a bitslab2d scan take their static per-ray
    # rectangles; "auto" (apx's default) and "off" share the window.
    beam_rects: str = "auto"

    def __post_init__(self):
        if self.raycast_backend not in RAYCAST_BACKENDS:
            raise ValueError(f"unknown raycast_backend {self.raycast_backend!r}; "
                             f"expected one of {RAYCAST_BACKENDS}")
        if self.beam_rects not in ("auto", "on", "off"):
            raise ValueError(f"unknown beam_rects {self.beam_rects!r}; "
                             "expected 'auto', 'on' or 'off'")

    @property
    def device(self) -> torch.device:
        return self.map_bank.device

    @property
    def ray_pad(self) -> int:
        """Padding of apx's ray-padded map, which sets the window starts:
        room for the range and, for K2's 8-aligned 24-row windows, at least
        16 cells (apx's ``ray_pad``)."""
        base = max(math.ceil(self.lidar_range) + 1, WIN // 2)
        return max(base, 16) if self.raycast_backend == "pallas_window" else base

    @property
    def _fits_window(self) -> bool:
        """Every cast of a step fits the 16-cell window (range <= 6)."""
        return self.lidar_range <= WIN // 2 - 2

    @property
    def use_pallas_window(self) -> bool:
        """K2 windows when every cast fits the 16-cell window (range <= 6);
        otherwise the backend casts on the whole map, as apx's does."""
        return self.raycast_backend == "pallas_window" and self._fits_window

    @property
    def use_bitslab2d(self) -> bool:
        """apx's 2-D bit window, where it fits: range <= 6 and maps of at most
        32x32 cells (else the dense casts). apx's ``"auto"`` resolves to it;
        the port's does not."""
        h, w = self.map_bank.map_hw
        return (self.raycast_backend == "bitslab2d" and self._fits_window
                and h <= 32 and w <= 32)

    @property
    def use_bitslab(self) -> bool:
        """apx's 16-column bit window, where it fits (range <= 6, W <= 32)."""
        return (self.raycast_backend == "bitslab" and self._fits_window
                and self.map_bank.map_hw[1] <= 32)

    @property
    def use_mxu_window(self) -> bool:
        return self.raycast_backend == "mxu_window" and self._fits_window

    @property
    def windowed(self) -> bool:
        return self.raycast_backend == "windowed"

    @property
    def move_len_contracted(self) -> bool:
        """Whether the jitted reference contracts the move cast's |d|
        (``sqrt(fma(dy, dy, dx*dx))``): under the windows cut by a
        per-cast slice or by one-hot products it does; on the whole map,
        the bit windows and K2's windows it rounds the square unfused."""
        return self.raycast_backend in ("windowed", "hybrid") or self.use_mxu_window

    @property
    def shared_window(self) -> str | None:
        """The window the casts of a step share, cut once from the pre-move
        position (``_make_window``): ``"bits"`` (from the row halves),
        ``"pallas_window"`` (K2) or ``"mxu_window"``; None where each cast
        runs on the whole map or cuts its own window."""
        if self.needs_row_halves:
            return "bits"
        if self.use_pallas_window:
            return "pallas_window"
        if self.use_mxu_window:
            return "mxu_window"
        return None

    def cuts_own_window(self, radius: int) -> bool:
        """A cast of this window radius without a shared window cuts its own
        around its origin (``_cast_window``): ``"windowed"``, and
        ``"hybrid"``'s short casts."""
        return self.windowed or (self.raycast_backend == "hybrid" and radius <= 2)

    @property
    def step_on_whole_map(self) -> bool:
        """Every cast of the step runs on the whole map (no shared window,
        no per-cast window for the move and candidates or for the beams, no
        beam tables), so the step is kernel S, one launch
        (``ops.lidar_fused_cuda.step``); elsewhere it is F1's stages around
        the casts."""
        return (self.shared_window is None and not self.beam_tables_active
                and not any(self.cuts_own_window(r) for r in (MOVE_RADIUS, self.ray_pad)))

    @property
    def reset_on_whole_map(self) -> bool:
        """The typed reset scan runs on the whole map (the bit windows' does
        too: it needs flank cells), so the reset is kernel R, one launch
        (``ops.lidar_fused_cuda.reset``); the window-frame backends cut a
        window for it."""
        return self.shared_window in (None, "bits") and not self.cuts_own_window(self.ray_pad)

    @property
    def needs_row_halves(self) -> bool:
        """The bit windows are cut from the row halves, packed at reset and
        carried in the state (``LIDARBitslabState``)."""
        return self.use_bitslab or self.use_bitslab2d

    @property
    def beam_tables_active(self) -> bool:
        return (self.use_beam_tables and self.map_bank.beam_face is not None
                and self.lidar_beam_count == 8)

    @functools.cached_property
    def beam_rects_on(self) -> tuple[tuple[int, int, int, int], ...] | None:
        """The beams' static window rectangles when ``beam_rects="on"``
        under bitslab2d, else None. The scan's origin lies in window
        coordinates [half - 1, half + 2] (closed): within 1.0 of the pre-move
        position, whose floor is the window's index ``half``."""
        if self.beam_rects != "on" or not self.use_bitslab2d:
            return None
        half = WIN // 2 - 1
        offs = lidar_directions_np(self.lidar_beam_count) * np.float32(self.lidar_range)
        return beam_cell_rects(offs, WIN, half - 1.0, half + 2.0)

    @functools.cached_property
    def beam_offsets(self) -> torch.Tensor:
        """(B, 2) f32 beam directions scaled by the range."""
        offs = lidar_directions_np(self.lidar_beam_count) * np.float32(self.lidar_range)
        return torch.from_numpy(offs).to(self.device)

    @functools.cached_property
    def beam_signs(self) -> torch.Tensor:
        """(8, 2) int32 ``BEAM_SIGNS`` on the device, for the table scan."""
        return torch.from_numpy(BEAM_SIGNS).to(self.device)

    @property
    def inv_range(self) -> float:
        """float32 1 / lidar_range, as a Python float."""
        return float(np.float32(1.0) / np.float32(self.lidar_range))

    @functools.cached_property
    def map_size(self) -> torch.Tensor:
        """(2,) f32 [W, H]."""
        h, w = self.map_bank.map_hw
        return torch.tensor([w, h], dtype=torch.float32, device=self.device)

    @functools.cached_property
    def inv_map_size(self) -> torch.Tensor:
        """(2,) f32 [1/W, 1/H]: XLA compiles the reference's divisions by
        the map size as multiplies by these float32 reciprocals (and
        ``p / size * 2 - 1`` as ``fma(p, 2 / size, -1)``)."""
        return torch.reciprocal(self.map_size)


@dataclasses.dataclass
class LIDARLocalizationState:
    occ: torch.Tensor  # (N, H, W) bool — current map
    bank_pos: torch.Tensor  # (N,) int64 — position in the bank
    map_idx: torch.Tensor  # (N,) int64 — dataset index of the map (uint32 range)
    pos: torch.Tensor  # (N, 2) f32 (x, y)
    # Odometry origin. The reference aliases it to pos at reset and then
    # mutates pos in place during the first step's movement, so the origin
    # is the position after the FIRST step's movement (before the clip);
    # odo_pending is True until that step locks it in.
    initial_pos: torch.Tensor  # (N, 2) f32
    odo_pending: torch.Tensor  # (N,) bool


@dataclasses.dataclass(frozen=True)
class BitWindow:
    """A step's window cut from the row halves: ``occ`` (N, 16, 16) rows x
    columns from ``base`` (N, 2) f32 (``two_d``), or (N, H, 16) columns
    from ``base[:, 0]``; the casts keep map coordinates."""

    occ: torch.Tensor
    base: torch.Tensor
    two_d: bool


@dataclasses.dataclass
class LIDARBitslabState(LIDARLocalizationState):
    """The state under the bitslab backends: the episode's map rows as
    16-bit half-words, packed once at reset (apx's ``row_halves`` leaf)."""

    row_halves: torch.Tensor  # (N, H, 2) int32


class LIDARLocalizationEnv(APEnv[LIDARLocalizationParams, LIDARLocalizationState]):
    def __init__(self, map_bank: MapBank | None = None, **config):
        self._map_bank = map_bank
        self._config = config

    def default_params(self, **overrides) -> LIDARLocalizationParams:
        cfg = {**self._config, **overrides}
        bank = cfg.pop("map_bank", self._map_bank)
        if bank is None:
            raise ValueError("LIDARLocalizationEnv requires a map bank")
        return LIDARLocalizationParams(map_bank=bank, **cfg)

    # ---- spaces / loss ------------------------------------------------------
    def observation_space(self, params) -> Space:
        h, w = params.map_bank.map_hw
        d: dict[str, Any] = {
            "lidar": Box(low=0.0, high=1.0, shape=(params.lidar_beam_count,)),
            "odometry": Box(low=-1.0, high=1.0, shape=(2,)),
        }
        if not params.static_map:
            d["map"] = Image.create(width=w, height=h, channels=1)
        return DictSpace(d)

    def inner_action_space(self, params) -> Space:
        return Box(low=-1.0, high=1.0, shape=(2,))

    def prediction_space(self, params) -> Space:
        return Box(low=-1.0, high=1.0, shape=(2,))

    def prediction_target_space(self, params) -> Space:
        return make_regression_loss_and_target_space(2, -1.0, 1.0)[1]

    def loss_fn(self, params) -> LossFn:
        return make_regression_loss_and_target_space(2, -1.0, 1.0)[0]

    # ---- casts ----------------------------------------------------------------
    def _make_window(self, state, params):
        """The occupancy window shared by a step's casts, around
        floor(state.pos) (a cast of the step starts within 1.0 of it and
        reaches at most the range): a ``BitWindow`` under the bitslab
        backends, an (occ (N, h, w), base (N, 2)) pair for the window-frame
        backends, or None when each cast runs on the whole map or cuts its
        own window."""
        half = WIN // 2 - 1
        kind = params.shared_window
        if kind == "bits":
            _, w = params.map_bank.map_hw
            base = torch.floor(state.pos) - half
            if params.use_bitslab2d:
                return BitWindow(bitslab_window_2d(state.row_halves, base[:, 0], base[:, 1], w),
                                 base, two_d=True)
            return BitWindow(bitslab_window(state.row_halves, base[:, 0], w), base, two_d=False)
        if kind == "pallas_window":
            starts, base = window_starts(state.pos, WIN, params.ray_pad)
            return extract_windows(state.occ, starts, params.ray_pad, WIN).view(torch.bool), base
        if kind == "mxu_window":
            return extract_window_mxu(state.occ, params.ray_pad, state.pos, WIN)
        return None

    @staticmethod
    def _cast(kernel, state, origin, targets, window, seg=None):
        """K1 on the whole map, or on the window (occ, base) in the window
        frame (``origin - base``, ``targets - base``); ``seg`` the casts'
        |d| in that frame, or None for the contracted length K1 computes."""
        occ = state.occ
        if window is not None:
            occ, base = window
            origin, targets = origin - base, targets - base[:, None, :]
        return kernel(occ, origin, targets, seg)

    @staticmethod
    def _cast_window(state, origin, radius: int, params):
        """The window a cast cuts around its own origin (``"windowed"``, and
        ``"hybrid"``'s moves), else None."""
        if params.cuts_own_window(radius):
            return windowed_window(state.occ, origin, radius, params.ray_pad)
        return None

    def _raycast(self, state, origin, targets, params, radius: int, typed: bool = False,
                 window=None, rho: int | None = None, ray_rects=None, seg=None):
        """(N, R) distances of the casts origin (N, 2) -> targets (N, R, 2)
        under the params' backend (apx's ``_raycast``): ``typed`` for the
        reset scan, ``radius`` the window radius of a cut-per-cast window,
        ``rho`` the cast's reach around the window's anchor (the bit
        windows' static slice), ``ray_rects`` the beams' static rectangles
        in a 2-D bit window, ``seg`` the casts' |d| in the cast's frame
        (None: the contracted length)."""
        kernel = raycast_typed if typed else raycast_fast
        if isinstance(window, BitWindow):
            if typed:  # the GEOS-typed reset scan needs flank cells: dense, on K1
                return self._cast(kernel, state, origin, targets, None, seg)
            bx, by = window.base[:, 0], window.base[:, 1]
            if not window.two_d:
                return raycast_grid_bitslab(window.occ, bx, origin, targets, seg)[0]
            if ray_rects is not None:
                return raycast_grid_bitslab2d_per_ray(window.occ, bx, by, origin, targets,
                                                      ray_rects, seg)[0]
            occ_win = window.occ
            if rho is not None:
                # apx's static slice: a cast reaching at most rho cells from
                # the window's anchor (index half) can meet only window cells
                # [half - rho - 1, half + rho]; the others fail a <= b.
                half = WIN // 2 - 1
                lo, hi = max(half - rho - 1, 0), min(half + rho + 1, WIN)
                occ_win, bx, by = occ_win[:, lo:hi, lo:hi], bx + lo, by + lo
            return raycast_grid_bitslab2d(occ_win, bx, by, origin, targets, seg)[0]
        if window is None:
            window = self._cast_window(state, origin, radius, params)
        if window is None and params.raycast_backend == "pallas":
            kernel = raycast_fast  # apx's Pallas backend: untyped, resets included
        return self._cast(kernel, state, origin, targets, window, seg)

    # ---- observation --------------------------------------------------------
    def _scan(self, state, params, targets, typed: bool = False, window=None) -> torch.Tensor:
        """(N, B) beam distances from state.pos to ``targets`` (N, B, 2): the
        face tables' lookups for a step scan with the tables active, else
        the casts (``typed`` for the reset scan, which cuts its own window
        from the reset position)."""
        if not typed and params.beam_tables_active:
            bank = params.map_bank
            return lidar_table_scan(bank.beam_face, bank.beam_axis, state.bank_pos, state.pos,
                                    params.beam_offsets, signs=params.beam_signs)
        if typed and params.shared_window != "bits":
            window = self._make_window(state, params)
        rects = None if typed else params.beam_rects_on
        return self._raycast(state, state.pos, targets, params, params.ray_pad, typed, window,
                             rho=math.ceil(params.lidar_range) + 1, ray_rects=rects)

    def _observe(self, state, params) -> dict[str, torch.Tensor]:
        """The reset's observation from the GEOS-typed scan under the
        params' backend (``lidar_fused.reset_observation``): the reset of
        the window-frame backends, and of states built from host maps
        (``compat.builders``)."""
        targets = state.pos[:, None, :] + params.beam_offsets  # (N, B, 2)
        dist = self._scan(state, params, targets, typed=True)
        return reset_observation(dist, state.pos, state.initial_pos, params.lidar_range,
                                 params.inv_map_size)

    def obs_derived_spec(self, params) -> dict[str, tuple[str, float]]:
        """``obs_derived_from_state`` as the fused merge computes it
        (``ops.merge``): the map obs is the bool ``occ`` leaf divided by
        255."""
        return {} if params.static_map else {"map": ("occ", 255.0)}

    def obs_derived_from_state(self, state, params) -> dict[str, torch.Tensor]:
        """obs["map"] = occ.astype(f32)/255: the reference divides the
        boolean cast by 255, so values are {0, 1/255}."""
        if params.static_map:
            return {}
        return {"map": div(state.occ[..., None].to(torch.float32), 255.0)}

    @staticmethod
    def _info(state) -> dict[str, torch.Tensor]:
        return {"map_idx": state.map_idx}

    # ---- dynamics -----------------------------------------------------------
    def draw_reset(self, num_envs, params, generator) -> dict[str, torch.Tensor]:
        """bank_pos ~ U[0, M) (or the static map) and k ~ U[0, n_free) for
        the k-th free cell. k is a 62-bit integer draw reduced mod n_free:
        always in range, with a bias below 2**-50."""
        bank = params.map_bank
        dev = params.device
        if params.static_map:
            bank_pos = torch.full((num_envs,), params.static_map_pos, dtype=torch.int64, device=dev)
        else:
            bank_pos = torch.randint(
                0, bank.num_maps, (num_envs,), generator=generator, device=dev
            )
        wide = torch.randint(
            0, 2**62, (num_envs,), generator=generator, device=dev, dtype=torch.int64
        )
        return {"bank_pos": bank_pos, "k": wide % bank.free_count(bank_pos)}

    def reset_from_draws(self, draws, params):
        """Kernel R where the reset scan runs on the whole map
        (``ops.lidar_fused_cuda.reset``: the map, the position, the scan and
        the observation in one launch; typed, or untyped under
        ``"pallas"``), reading the bank itself where it is whole and no
        row halves are carried, else from ``MapBank.spawn``'s fetch;
        elsewhere the map and position unpacked from the fetch and the scan
        on the backend's window."""
        return self._reset(draws, params)

    def autoreset_from_draws(self, draws, old_state, params, only=None):
        """``reset_from_draws`` for the envs ``only`` selects ((N,) bool;
        None: every env): R computes no other env, whose leaves are then
        unspecified (``lidar_fused.RESET_POISON`` on the CPU). The window
        backends compute every env."""
        return self._reset(draws, params, only)

    def _reset(self, draws, params, only=None):
        bank = params.map_bank
        _, w = bank.map_hw
        bank_pos = draws["bank_pos"].to(torch.int64)
        k = draws["k"].to(torch.int64)
        scan = (w, params.beam_offsets, params.lidar_range, params.inv_map_size,
                params.raycast_backend != "pallas")
        words = r = None
        if params.reset_on_whole_map and bank.shard is None and not params.needs_row_halves:
            r = lidar_fused_cuda.reset(bank.row_words, bank.free_cells, *scan, only=only,
                                       fetch=(bank_pos, k, bank.indices))
            map_idx = r["map_idx"]
        else:
            words, flat_idx, map_idx = bank.spawn(bank_pos, k)  # k-th free cell, row-major
            if params.reset_on_whole_map:
                r = lidar_fused_cuda.reset(words, flat_idx, *scan, only=only)
        obs = None
        if r is not None:
            occ, pos, odo_pending = r["occ"], r["pos"], r["odo_pending"]
            obs = {"lidar": r["lidar"], "odometry": r["odometry"]}
        else:
            occ, pos = spawn_leaves(words, flat_idx, w)
            odo_pending = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
        leaves = dict(occ=occ, bank_pos=bank_pos, map_idx=map_idx, pos=pos, initial_pos=pos,
                      odo_pending=odo_pending)
        if params.needs_row_halves:
            state = LIDARBitslabState(**leaves, row_halves=halves_of_words(words))
        else:
            state = LIDARLocalizationState(**leaves)
        if obs is None:
            obs = self._observe(state, params)
        return obs, state, self._info(state)

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        """Kernel S where every cast runs on the whole map
        (``ops.lidar_fused_cuda.step``: the step in one launch); elsewhere
        the step's three casts (the move, the two wall-slide candidates,
        the beams) on the backend's windows with F1's four stages between
        them (``lidar_step.staged_step`` over ``ops.lidar_step_cuda``). On
        the card an action that requires grad raises; on the CPU both run
        their plain forms. The rounding sites are where XLA's fused
        reference rounds (``core.numerics``)."""
        pos = state.pos.contiguous()
        args = (action.contiguous(), pos, state.odo_pending.contiguous(),
                state.initial_pos.contiguous(), params.map_size, params.inv_map_size,
                params.beam_offsets, params.inv_range)
        if params.step_on_whole_map:
            out = lidar_fused_cuda.step(state.occ.contiguous(), *args)
        else:
            # One window per step, from the pre-move position: every cast of
            # the step stays within it. The move cast of the per-cast window
            # backends cuts its own.
            window = self._make_window(state, params)
            move_window = (window if window is not None
                           else self._cast_window(state, pos, MOVE_RADIUS, params))
            base = move_window[1].contiguous() if isinstance(move_window, tuple) else None

            def cast_move(origin, targets, seg):
                return self._raycast(state, origin, targets, params, MOVE_RADIUS,
                                     window=move_window, rho=MOVE_RADIUS, seg=seg)

            def cast_candidates(origin, targets):
                return self._raycast(state, origin, targets, params, MOVE_RADIUS, window=window,
                                     rho=MOVE_RADIUS)

            def scan(new_pos, targets):
                return self._scan(dataclasses.replace(state, pos=new_pos), params, targets,
                                  window=window)

            # The move cast's |d| is contracted in the reference only under
            # some backends; where it is not, stage A rounds it in the
            # cast's frame.
            out = lidar_step.staged_step(lidar_step_cuda, *args, cast_move, cast_candidates,
                                         scan, unfused_len=not params.move_len_contracted,
                                         base=base)
        new_state = dataclasses.replace(state, pos=out["pos"], initial_pos=out["initial_pos"],
                                        odo_pending=out["odo_pending"])
        return APStepResult(
            obs={"lidar": out["lidar"], "odometry": out["odometry"]},
            state=new_state,
            base_reward=out["base_reward"],
            terminated=out["terminated"],
            truncated=out["truncated"],
            info=self._info(new_state),
            prediction_target=out["target"],
        )

    def prediction_target_on_reset(self, old_state, new_state, params):
        return fma(old_state.pos, 2.0 * params.inv_map_size, -1.0)
