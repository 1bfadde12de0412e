"""2D LIDAR localization environment, batched over envs (counterpart of
apx.envs.lidar_localization).

Same semantics as apx's env (its module docstring lists the reference
behaviours kept): 8 beams of range 5 with lidar obs = clip(dist / range),
odometry = (pos - initial_pos) / [W, H], the dynamic-map obs occ / 255,
base reward 0.1 - 1e-3 |a|^2, the move-to-wall cast and the reference's
wall slide with its quirks, out-of-map termination, the previous position
as the prediction target, spawns uniform over free cells, and a fresh
bank map per episode.

Every cast goes through K1 (``apx_torch.ops.raycast_cuda``): the step's
movement cast (1 ray), wall-slide cast (2 rays) and beam scan
(``raycast_fast``), and the GEOS-typed reset scan (``raycast_typed``).
Two of apx's raycast backends are ported:

* ``"auto"`` (the default): apx casts against a bit-packed 16x16 window;
  that form is bitwise-equal to the dense cast computed here (pinned in
  apx's tests/test_lidar.py), so the port's results equal apx's ``"auto"``
  env. The casts run on the whole (H, W) map.
* ``"pallas_window"``: K2 (``apx_torch.ops.window_cuda``) cuts one (24, 16)
  window of the ray-padded map per env around the step's pre-move
  position, and the step's three casts run on it in the window frame
  (``origin - base``, ``targets - base``); the reset cuts its own window
  from the reset position for the typed scan. This rounds at other sites
  than the dense form, so it equals apx's ``"pallas_window"`` env, not the
  default one. apx carries the ray-padded map, (N, H + 2 pad, W + 2 pad),
  as a state leaf; the port does not: K2 cuts the padded map's window from
  ``occ`` itself (the padding is zeros), so the state keeps the same six
  leaves under both backends, and every obs, reward and done stays apx's.

The other apx backends are not ported (ROADMAP.md, queue 1).
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
from ..data.floor_map import MapBank
from ..ops.geometry import normalize_into_unit_ball
from ..ops.raycast import lidar_directions_np, seg_length
from ..ops.raycast_cuda import raycast_fast, raycast_typed
from ..ops.window import WIN, window_starts
from ..ops.window_cuda import extract_windows
from .common import make_regression_loss_and_target_space

__all__ = ["LIDARLocalizationEnv", "LIDARLocalizationParams", "LIDARLocalizationState"]


@dataclasses.dataclass(frozen=True, eq=False)
class LIDARLocalizationParams:
    map_bank: MapBank
    static_map: bool = False
    static_map_pos: int = 0
    lidar_beam_count: int = 8
    lidar_range: float = 5.0
    # apx's raycast backend switch: "auto" (dense casts, equal to apx's
    # "auto") or "pallas_window" (K2 windows); the other backends stay
    # JAX-only.
    raycast_backend: str = "auto"
    use_beam_tables: bool = False
    beam_rects: str = "auto"

    def __post_init__(self):
        if self.raycast_backend not in ("auto", "pallas_window"):
            raise NotImplementedError(
                f"raycast_backend={self.raycast_backend!r} is not ported; the port has "
                "'auto' and 'pallas_window' (ROADMAP.md, queue 1: the other window forms)"
            )
        if self.use_beam_tables or self.beam_rects == "on":
            raise NotImplementedError(
                "beam tables and per-beam rectangles are not ported (ROADMAP.md, queue 1)"
            )

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
    def use_pallas_window(self) -> bool:
        """K2 windows when every cast fits the 16-cell window (range <= 6);
        otherwise the backend casts on the whole map, as apx's does."""
        return self.raycast_backend == "pallas_window" and self.lidar_range <= WIN // 2 - 2

    @functools.cached_property
    def beam_offsets(self) -> torch.Tensor:
        """(B, 2) f32 beam directions scaled by the range."""
        offs = lidar_directions_np(self.lidar_beam_count) * np.float32(self.lidar_range)
        return torch.from_numpy(offs).to(self.device)

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
        """One occupancy window shared by a step's casts, cut by K2 from
        the ray-padded map around floor(state.pos), read from state.occ:
        ((N, 24, 16) bool window, (N, 2) f32 base), or None when the casts
        run on the whole map."""
        if not params.use_pallas_window:
            return None
        starts, base = window_starts(state.pos, WIN, params.ray_pad)
        return extract_windows(state.occ, starts, params.ray_pad, WIN).view(torch.bool), base

    @staticmethod
    def _cast(kernel, state, origin, targets, window, unfused_len: bool = False):
        """K1 on the whole map, or on the window in the window frame
        (``origin - base``, ``targets - base``). Each segment's |d| is
        ``seg_length``'s contracted form unless ``unfused_len``, as the
        reference rounds it at the cast's site."""
        occ = state.occ
        if window is not None:
            occ, base = window
            origin, targets = origin - base, targets - base[:, None, :]
        seg = None
        if unfused_len:
            d = targets - origin[:, None, :]
            seg = sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
        return kernel(occ, origin, targets, seg)

    # ---- observation --------------------------------------------------------
    def _observe(self, state, params, typed: bool = False, window=None) -> dict[str, torch.Tensor]:
        targets = state.pos[:, None, :] + params.beam_offsets  # (N, B, 2)
        if typed:
            # The reset scan cuts its own window from the reset position.
            window = self._make_window(state, params)
            dist = self._cast(raycast_typed, state, state.pos, targets, window)
            lidar = div(dist, params.lidar_range)
        else:
            # XLA compiles the step's division by the range as a multiply by
            # its float32 reciprocal (the reset scan's stays a division).
            dist = self._cast(raycast_fast, state, state.pos, targets, window)
            lidar = dist * params.inv_range
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
        return {"bank_pos": bank_pos, "k": wide % bank.free_counts[bank_pos]}

    def reset_from_draws(self, draws, params):
        bank = params.map_bank
        _, w = bank.map_hw
        bank_pos = draws["bank_pos"].to(torch.int64)
        k = draws["k"].to(torch.int64)
        occ = bank.fetch(bank_pos)
        flat_idx = bank.free_cells[bank_pos, k]  # k-th free cell, row-major
        pos = torch.stack([flat_idx % w, flat_idx // w], dim=-1).to(torch.float32) + 0.5
        state = LIDARLocalizationState(
            occ=occ,
            bank_pos=bank_pos,
            map_idx=bank.indices[bank_pos],
            pos=pos,
            initial_pos=pos,
            odo_pending=torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device),
        )
        return self._observe(state, params, typed=True), state, self._info(state)

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        # The FMA sites below are where XLA's fused reference contracts a
        # multiply into the following add (core.numerics).
        pos = state.pos
        base_reward = fma(torch.full_like(pos[:, 0], -1e-3), sum_squares(action), 0.1)

        a = normalize_into_unit_ball(action)
        total = seg_length(a)
        direction = a / torch.where(total == 0.0, 1.0, total)[:, None]

        # One window per step, from the pre-move position: every cast of the
        # step stays within it (None on the whole-map path).
        window = self._make_window(state, params)

        # First leg: move up to the nearest wall. This one-ray cast's |d| is
        # not contracted in the reference.
        move_to = (pos + a)[:, None, :]
        d2w = self._cast(raycast_fast, state, pos, move_to, window, unfused_len=True)[:, 0]
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
        cand_dist = self._cast(raycast_fast, state, pos1, pos1[:, None, :] + cand, window)
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
