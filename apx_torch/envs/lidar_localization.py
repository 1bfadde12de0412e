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
  whole map through K1 (``apx_torch.ops.raycast_cuda``): the step's
  movement cast (1 ray), wall-slide cast (2 rays) and beam scan
  (``raycast_fast``), and the GEOS-typed reset scan (``raycast_typed``).
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
  PyTorch on the card; the GEOS-typed reset scan stays dense, on K1.
* ``"windowed"``: each cast runs K1 on the (2 radius + 2)^2 window around
  its own origin, in the window frame (radius 2 for the moves, ``ray_pad``
  for the scans); ``"hybrid"``: the moves so, the scans on the whole map.
* ``"mxu_window"``: one 16x16 window per step (and per reset) around the
  pre-move position, by one-hot products; every cast runs K1 on it.
* ``"pallas_window"``: K2 (``apx_torch.ops.window_cuda``) cuts one (24, 16)
  window per env around the step's pre-move position, and the step's three
  casts run K1 on it; the reset cuts its own window for the typed scan.
* ``"pallas"``: every cast, the reset scan included, is K1's untyped
  ``raycast_fast`` on the whole map: apx's Pallas backend skips the GEOS
  typing at reset.

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
from ..core.numerics import div, fma, sqrt, sum_squares
from ..core.spaces import Box, DictSpace, Image, Space
from ..data.floor_map import BEAM_SIGNS, MapBank, halves_of_words, unpack_words
from ..ops.geometry import normalize_into_unit_ball
from ..ops.raycast import (beam_cell_rects, bitslab_window, bitslab_window_2d,
                           extract_window_mxu, lidar_directions_np, lidar_table_scan,
                           raycast_grid_bitslab, raycast_grid_bitslab2d,
                           raycast_grid_bitslab2d_per_ray, seg_length, windowed_window)
from ..ops.raycast_cuda import raycast_fast, raycast_typed
from ..ops.window import WIN, window_starts
from ..ops.window_cuda import extract_windows
from .common import make_regression_loss_and_target_space

__all__ = ["LIDARLocalizationEnv", "LIDARLocalizationParams", "LIDARLocalizationState",
           "LIDARBitslabState", "BitWindow", "RAYCAST_BACKENDS"]

RAYCAST_BACKENDS = ("auto", "xla", "bitslab2d", "bitslab", "windowed", "hybrid", "mxu_window",
                    "pallas_window", "pallas")


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
        if params.needs_row_halves:
            _, w = params.map_bank.map_hw
            base = torch.floor(state.pos) - half
            if params.use_bitslab2d:
                return BitWindow(bitslab_window_2d(state.row_halves, base[:, 0], base[:, 1], w),
                                 base, two_d=True)
            return BitWindow(bitslab_window(state.row_halves, base[:, 0], w), base, two_d=False)
        if params.use_pallas_window:
            starts, base = window_starts(state.pos, WIN, params.ray_pad)
            return extract_windows(state.occ, starts, params.ray_pad, WIN).view(torch.bool), base
        if params.use_mxu_window:
            return extract_window_mxu(state.occ, params.ray_pad, state.pos, WIN)
        return None

    @staticmethod
    def _seg(origin, targets, unfused_len: bool):
        """Each segment's |d|: ``seg_length``'s contracted form unless
        ``unfused_len``, as the reference rounds it at the cast's site."""
        if not unfused_len:
            return None
        d = targets - origin[:, None, :]
        return sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])

    @staticmethod
    def _cast(kernel, state, origin, targets, window, unfused_len: bool = False):
        """K1 on the whole map, or on the window (occ, base) in the window
        frame (``origin - base``, ``targets - base``)."""
        occ = state.occ
        if window is not None:
            occ, base = window
            origin, targets = origin - base, targets - base[:, None, :]
        return kernel(occ, origin, targets, LIDARLocalizationEnv._seg(origin, targets,
                                                                      unfused_len))

    def _raycast(self, state, origin, targets, params, radius: int, typed: bool = False,
                 window=None, rho: int | None = None, ray_rects=None,
                 unfused_len: bool = False):
        """(N, R) distances of the casts origin (N, 2) -> targets (N, R, 2)
        under the params' backend (apx's ``_raycast``): ``typed`` for the
        reset scan, ``radius`` the window radius of a cut-per-cast window,
        ``rho`` the cast's reach around the window's anchor (the bit
        windows' static slice), ``ray_rects`` the beams' static rectangles
        in a 2-D bit window."""
        kernel = raycast_typed if typed else raycast_fast
        if isinstance(window, BitWindow):
            if typed:  # the GEOS-typed reset scan needs flank cells: dense, on K1
                return self._cast(kernel, state, origin, targets, None, unfused_len)
            seg = self._seg(origin, targets, unfused_len)
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
        if window is not None:
            return self._cast(kernel, state, origin, targets, window, unfused_len)
        backend = params.raycast_backend
        if backend == "windowed" or (backend == "hybrid" and radius <= 2):
            local = windowed_window(state.occ, origin, radius, params.ray_pad)
            return self._cast(kernel, state, origin, targets, local, unfused_len)
        if backend == "pallas":  # apx's Pallas backend: untyped, resets included
            kernel = raycast_fast
        return self._cast(kernel, state, origin, targets, None, unfused_len)

    # ---- observation --------------------------------------------------------
    def _observe(self, state, params, typed: bool = False, window=None) -> dict[str, torch.Tensor]:
        targets = state.pos[:, None, :] + params.beam_offsets  # (N, B, 2)
        if not typed and params.beam_tables_active:
            bank = params.map_bank
            dist = lidar_table_scan(bank.beam_face, bank.beam_axis, state.bank_pos, state.pos,
                                    params.beam_offsets, signs=params.beam_signs)
        else:
            if typed and not params.needs_row_halves:
                # The reset scan cuts its own window from the reset position.
                window = self._make_window(state, params)
            rects = None if typed else params.beam_rects_on
            dist = self._raycast(state, state.pos, targets, params, params.ray_pad, typed,
                                 window, rho=math.ceil(params.lidar_range) + 1, ray_rects=rects)
        # XLA compiles the step's division by the range as a multiply by its
        # float32 reciprocal (the reset scan's stays a division).
        lidar = div(dist, params.lidar_range) if typed else dist * params.inv_range
        return {
            "lidar": lidar.clamp(-1.0, 1.0),
            "odometry": (state.pos - state.initial_pos) * params.inv_map_size,
        }

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
        bank = params.map_bank
        _, w = bank.map_hw
        bank_pos = draws["bank_pos"].to(torch.int64)
        k = draws["k"].to(torch.int64)
        words, flat_idx, map_idx = bank.spawn(bank_pos, k)  # k-th free cell, row-major
        pos = torch.stack([flat_idx % w, flat_idx // w], dim=-1).to(torch.float32) + 0.5
        leaves = dict(
            occ=unpack_words(words, w),
            bank_pos=bank_pos,
            map_idx=map_idx,
            pos=pos,
            initial_pos=pos,
            odo_pending=torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device),
        )
        if params.needs_row_halves:
            state = LIDARBitslabState(**leaves, row_halves=halves_of_words(words))
        else:
            state = LIDARLocalizationState(**leaves)
        return self._observe(state, params, typed=True), state, self._info(state)

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        # The FMA sites below are where XLA's fused reference contracts a
        # multiply into the following add (core.numerics).
        pos = state.pos
        base_reward = fma(-1e-3, sum_squares(action), 0.1)

        a = normalize_into_unit_ball(action)
        total = seg_length(a)
        direction = a / torch.where(total == 0.0, 1.0, total)[:, None]

        # One window per step, from the pre-move position: every cast of the
        # step stays within it (None on the whole-map path).
        window = self._make_window(state, params)

        # First leg: move up to the nearest wall. This one-ray cast's |d| is
        # contracted in the reference only under some backends.
        move_to = (pos + a)[:, None, :]
        d2w = self._raycast(state, pos, move_to, params, 2, window=window, rho=2,
                            unfused_len=not params.move_len_contracted)[:, 0]
        pos1 = fma(direction, d2w[:, None], pos)

        # Wall slide, reference quirks included: only components > 1e-5
        # (positive!) survive, and a single survivor v becomes
        # diag([v, v]) — candidates on BOTH axes.
        rem = total - d2w
        rem_vec = direction * rem[:, None]
        keep = rem_vec > 1e-5
        n_keep = keep.sum(dim=-1)
        v_single = torch.where(keep, rem_vec, 0.0).amax(dim=-1)
        cand_diag = torch.where((n_keep == 2)[:, None], rem_vec, v_single[:, None].expand(-1, 2))
        eye = torch.eye(2, dtype=torch.float32, device=pos.device)
        cand = eye * cand_diag[:, None, :]  # (N, 2, 2) candidate moves
        cand_dist = self._raycast(state, pos1, pos1[:, None, :] + cand, params, 2, window=window,
                                  rho=2)
        # The surviving candidate, as a binary select (apx's form).
        use0 = cand_dist[:, 0] > 0.0
        sel_cand = torch.where(use0[:, None], cand[:, 0], cand[:, 1])
        sel_diag = torch.where(use0, cand_diag[:, 0], cand_diag[:, 1])
        sel_dist = torch.where(use0, cand_dist[:, 0], cand_dist[:, 1])
        unit = sel_cand / torch.where(sel_diag == 0.0, 1.0, sel_diag)[:, None]
        do_slide = (total > 0.0) & (rem > 1e-5) & (n_keep > 0)
        pos2 = torch.where(do_slide[:, None], fma(unit, sel_dist[:, None], pos1), pos1)
        pos2 = torch.where((total > 0.0)[:, None], pos2, pos)

        size = params.map_size
        terminated = (pos2 < 0.0).any(dim=-1) | (pos2 >= size).any(dim=-1)
        # The first step after a reset locks the odometry origin to the
        # pre-clip moved position (see LIDARLocalizationState).
        new_initial = torch.where(state.odo_pending[:, None], pos2, state.initial_pos)
        pos2 = torch.minimum(pos2.clamp_min(0.0), size)

        new_state = dataclasses.replace(
            state,
            pos=pos2,
            initial_pos=new_initial,
            odo_pending=torch.zeros_like(state.odo_pending),
        )
        target = fma(pos, 2.0 * params.inv_map_size, -1.0)
        return APStepResult(
            obs=self._observe(new_state, params, window=window),
            state=new_state,
            base_reward=base_reward,
            terminated=terminated,
            truncated=torch.zeros_like(terminated),
            info=self._info(new_state),
            prediction_target=target,
        )

    def prediction_target_on_reset(self, old_state, new_state, params):
        return fma(old_state.pos, 2.0 * params.inv_map_size, -1.0)
