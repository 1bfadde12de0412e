"""Render bookkeeping for the compat adapter (env 0 of the batch;
counterpart of apx.compat.render_hooks).

Mirrors the reference's per-step render state updates: the visitation /
prediction-quality overlay of image envs (image_perception_module.py:
219-234), LightDark's trajectory/obs markers (light_dark.py:146-149), and
LIDAR's fog-of-war observation map (lidar_localization2d.py:238-261).

The tracker runs on every step. The state leaves it reads are env 0's
slices (``tracker_slices``), which the adapter copies to the host in the
step's one transfer beside the obs, so the tracker adds no synchronising
copy of its own.
"""

from __future__ import annotations

import numpy as np
import scipy.special

from ..envs.image_classification import ImageClassificationEnv
from ..envs.image_localization import ImageLocalizationEnv
from ..envs.lidar_localization import LIDARLocalizationEnv
from ..envs.light_dark import LightDarkEnv
from ..render import RenderTracker
from ..render.render import _render_geometry, _to_render_coords
from .builders import unwrap_state

__all__ = ["tracker_slices", "update_tracker_reset", "update_tracker_step"]


def tracker_slices(base_env, state, old_state=None) -> dict:
    """Env 0's device tensors the tracker reads: the LIDAR map and position
    after the step and the position before it, the localization target."""
    s = unwrap_state(state)
    if isinstance(base_env, LIDARLocalizationEnv):
        out = {"occ": s.occ[0], "pos": s.pos[0]}
        if old_state is not None:
            out["prev_pos"] = unwrap_state(old_state).pos[0]
        return out
    if isinstance(base_env, ImageLocalizationEnv):
        return {"target": s.target[0]}
    return {}


def _info_target(info):
    """Prediction target from a step info dict, unwrapping the sparse
    {"target", "weight"} form; None on full-reset steps (no step info)."""
    pred = info.get("prediction")
    if not isinstance(pred, dict) or "target" not in pred:
        return None
    target = pred["target"]
    if isinstance(target, dict):
        target = target["target"]
    return np.asarray(target)


def _image_geom(params):
    h, w, _ = params.dataset.image_shape
    return _render_geometry((h, w), params.sensor_size, params.sensor_scale)


def update_tracker_reset(tracker: RenderTracker, base_env, params, obs0, first: dict):
    """``obs0``: the reset's numpy obs (batched); ``first``: the host copies
    of ``tracker_slices``."""
    tracker.reset()
    if isinstance(base_env, (ImageClassificationEnv, ImageLocalizationEnv)):
        render_size, _, _, _ = _image_geom(params)
        tracker.visitation = np.zeros((render_size[1], render_size[0]), np.int32)
        tracker.quality_map = np.zeros((render_size[1], render_size[0]), np.float32)
        tracker.last_pos = obs0["glimpse_pos"][0]
    elif isinstance(base_env, LIDARLocalizationEnv):
        occ = first["occ"]
        tracker.observation_map = np.zeros_like(occ, dtype=bool)
        _update_lidar_fog(tracker, occ, first["pos"],
                          np.asarray(obs0["lidar"][0]) * params.lidar_range,
                          params)
        tracker.last_lidar = np.asarray(obs0["lidar"][0]) * params.lidar_range
    elif isinstance(base_env, LightDarkEnv):
        tracker.last_obs = np.asarray(obs0["noisy_position"][0])


def update_tracker_step(
    tracker: RenderTracker, base_env, params, action, obs, info, first: dict,
    was_reset: bool = False,
):
    pred = np.asarray(action["prediction"])
    if pred.ndim:
        pred0 = pred[0] if pred.ndim > 1 else pred
    else:
        pred0 = pred

    if isinstance(base_env, (ImageClassificationEnv, ImageLocalizationEnv)):
        pos = obs["glimpse_pos"][0]
        target = info["prediction"]["target"]
        if isinstance(target, dict):
            target = target["target"]
        target = np.asarray(target)[0] if np.asarray(target).ndim else target
        if isinstance(base_env, ImageClassificationEnv):
            # Quality vs the PRE-step labels (image_classification.py:113-118,
            # == the info target even across lockstep resets).
            probs = scipy.special.softmax(pred0)
            quality = float(probs[int(np.asarray(target).flat[0])])
        else:
            # Localization quality uses the CURRENT (possibly freshly
            # resampled) target, not the info target
            # (image_localization.py:152-159) — read it from the state.
            quality = float(
                1 - np.linalg.norm(pred0 - first["target"]) / np.sqrt(4)
            )
            tracker.last_pred = pred0
        # The reference stamps the overlay at the PRE-step glimpse position
        # with the current prediction quality (module.py:196, :219-234),
        # then (on the lockstep reset step) clears it (:184-186).
        if tracker.last_pos is not None:
            _update_visitation(tracker, params, tracker.last_pos, quality)
        if was_reset and tracker.visitation is not None:
            tracker.visitation.fill(0)
            tracker.quality_map.fill(0)
        tracker.trajectory.append((pos.copy(), quality))
        tracker.last_pos = pos
    elif isinstance(base_env, LightDarkEnv):
        target = _info_target(info)
        if target is None:
            return
        t0 = target[0] if target.ndim > 1 else target
        quality = float(max(1 - np.linalg.norm(pred0 - t0) / 0.5, 0))
        tracker.last_pred = pred0
        tracker.last_pos = t0  # previous position (the loss target)
        tracker.trajectory.append((t0.copy(), quality))
        tracker.last_obs = obs["noisy_position"][0]
    elif isinstance(base_env, LIDARLocalizationEnv):
        occ = first["occ"]
        pos = first["pos"]
        prev_pos = first["prev_pos"]
        size = np.array([occ.shape[1], occ.shape[0]], np.float64)
        target = _info_target(info)
        if target is None:
            return
        t0 = target[0] if target.ndim > 1 else target
        quality = float(min(1 - np.linalg.norm(pred0 - t0) / 0.25, 1))
        tracker.last_pred = (pred0 + 1) / 2 * size
        tracker.last_pos = prev_pos
        tracker.trajectory.append((np.asarray(prev_pos, np.float64), quality))
        dist = np.asarray(obs["lidar"][0]) * params.lidar_range
        tracker.last_lidar = dist
        if tracker.observation_map is None or tracker.observation_map.shape != occ.shape:
            tracker.observation_map = np.zeros_like(occ, dtype=bool)
        _update_lidar_fog(tracker, occ, pos, dist, params)


def _update_visitation(tracker, params, pos_norm, quality):
    """Mirrors __update_visitation_overlay (module.py:219-234): rounded
    center +/- rounded size with edge-clipped coordinates (numpy fancy
    indexing buffers duplicate clipped indices, exactly like the
    reference's += on clipped coords)."""
    if tracker.visitation is None:
        return
    from ..render.render import stamp_rect

    render_size, scaling, eff, lim = _image_geom(params)
    c = _to_render_coords(np.asarray(pos_norm), render_size, scaling, lim)
    stamp_rect(
        tracker.visitation[None],
        tracker.quality_map[None],
        c[None],
        np.flip(eff * scaling),
        quality,
    )


def _update_lidar_fog(tracker, occ, pos, distances, params):
    """Mark observed cells like __get_obs (lidar_localization2d.py:244-261):
    (a) each hitting beam's CONTACT cell — reconstructed from the entry
    point (distance + the 1e-3 eps pullback) with the boundary-coordinate
    adjustment of :529-535, so the WALL cell itself defogs; (b) scan points
    along each beam within its measured range (the reference's 'good
    enough' free-space approximation)."""
    distances = np.asarray(distances)
    ang = np.linspace(-np.pi, np.pi, params.lidar_beam_count, endpoint=False)
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1)

    # (a) contact cells. A beam hit iff its distance is short of the full
    # segment length (computed in f32 exactly like the device raycast).
    seg = np.linalg.norm(
        (params.lidar_range * dirs).astype(np.float32), axis=-1
    )
    hit = distances < seg
    entry = pos[None, :] + dirs * (distances + 1e-3)[:, None]
    coords = np.floor(entry)
    exact = np.abs(coords - entry) < 1e-5
    target = pos[None, :] + dirs * params.lidar_range
    coords = np.where(exact & (target < pos[None, :]), coords - 1, coords)
    coords = coords[hit].astype(int)
    ok = (coords >= 0).all(axis=-1) & (
        coords < np.array([occ.shape[1], occ.shape[0]])
    ).all(axis=-1)
    sel = coords[ok]
    tracker.observation_map[sel[:, 1], sel[:, 0]] = True

    # (b) free-space scan points.
    ts = np.arange(0, params.lidar_range, 0.05)
    pts = pos[None, None, :] + ts[None, :, None] * dirs[:, None, :]
    within = ts[None, :] <= distances[:, None]
    cells = np.floor(pts).astype(int)
    ok = (
        within
        & (cells[..., 0] >= 0)
        & (cells[..., 0] < occ.shape[1])
        & (cells[..., 1] >= 0)
        & (cells[..., 1] < occ.shape[0])
    )
    sel = cells[ok]
    tracker.observation_map[sel[:, 1], sel[:, 0]] = True
