"""Host-side rendering for all env families (counterpart of
apx.render.render; numpy, and PIL imported inside the drawing functions).

Behavioral mirror of the reference's PIL rendering:
  * image envs: upscaled image + visitation/quality overlay + glimpse box
    (image_perception_module.py:333-401); localization adds target/pred
    boxes (image_localization.py:183-223),
  * LightDark: brightness field, noise-std disc, trajectory trail colored
    by prediction quality, obs/pred/agent dots (light_dark.py:155-247),
  * LIDAR: map with fog-of-war alpha, beams + contact markers, trail,
    pred/agent dots (lidar_localization2d.py:391-494).

Rendering is episodic host bookkeeping, not a hot path; a RenderTracker
accumulates the cross-step state (visitation, trails, last readings) that
the functional env state deliberately does not carry. ``render_env`` reads
env 0 of the port's batched state (copied to the host); LightDark's
brightness field comes from the port's ``envs.light_dark.brightness`` on
CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .style import (
    COLOR_AGENT,
    COLOR_OBS_PRIMARY,
    COLOR_OBS_SECONDARY,
    COLOR_PRED,
    quality_color,
)

__all__ = [
    "RenderTracker",
    "render_image_perception",
    "render_light_dark",
    "render_lidar",
    "render_env",
    "stamp_rect",
    "visitation_overlay",
    "blend_overlay",
    "upscale_to_rgb",
    "outlined_box",
]

def _glimpse_border_width(render_size) -> int:
    """max(1, round(W/128)) like the reference (module.py:463-465)."""
    return max(1, int(round(1 / 128 * render_size[0])))


@dataclasses.dataclass
class RenderTracker:
    """Cross-step render bookkeeping for one env instance (num_envs=1 per
    tracker; the compat layer keeps one per sub-env)."""

    trajectory: list = dataclasses.field(default_factory=list)  # (pos, quality)
    visitation: np.ndarray | None = None  # (H', W') int
    quality_map: np.ndarray | None = None  # (H', W') f32
    observation_map: np.ndarray | None = None  # (H, W) bool (lidar fog)
    last_pred: np.ndarray | None = None
    last_pos: np.ndarray | None = None
    last_obs: np.ndarray | None = None
    last_lidar: np.ndarray | None = None

    def reset(self):
        self.trajectory.clear()
        self.visitation = None
        self.quality_map = None
        self.observation_map = None
        self.last_pred = None
        self.last_pos = None
        self.last_obs = None
        self.last_lidar = None


def _to_pil(arr: np.ndarray):
    import PIL.Image

    return PIL.Image.fromarray(arr)


def _render_geometry(image_hw, sensor_size, sensor_scale):
    h, w = image_hw
    render_width = max(128, w)
    scaling = render_width / w
    render_size = (render_width, int(round(scaling * h)))
    eff = np.array(sensor_size, dtype=np.float64) * sensor_scale
    lim = (np.array([w, h]) - 1) / 2 - (eff - 1) / 2
    return render_size, scaling, eff, lim


def _to_render_coords(pos_norm, render_size, scaling, lim):
    return pos_norm * lim * scaling + np.array(render_size) / 2


def stamp_rect(counts, qmap, centers_xy, stamp_wh, quality=None):
    """Mark one axis-aligned sensor footprint per env on batched canvases.

    ``counts``: (N, H', W') int visitation counter, incremented in place over
    the stamped rectangle. ``qmap``: (N, H', W') float, overwritten with the
    clipped per-env ``quality`` where given. ``centers_xy``: (N, 2) float
    render coordinates; ``stamp_wh``: (2,) float (width, height).

    Semantics are the reference's pinned overlay update
    (image_perception_module.py:219-234): center and size round to ints, the
    footprint extends size//2 left/up of the center, and the EDGE-CLIPPED
    rectangle is marked — i.e. a footprint hanging off the canvas collapses
    onto the border row/column and each covered cell counts exactly once per
    stamp (numpy's fancy-index += buffers the duplicate clipped coordinates,
    so they collapse to one increment), and a size that rounds to zero
    stamps nothing. One batched fancy-index update covers all N envs."""
    centers = np.round(np.asarray(centers_xy)).astype(np.int64).reshape(len(counts), 2)
    w, h = (int(v) for v in np.round(np.asarray(stamp_wh, dtype=np.float64)))
    if w <= 0 or h <= 0:
        return
    height, width = counts.shape[-2:]
    xs = np.clip(centers[:, :1] - w // 2 + np.arange(w), 0, width - 1)  # (N, w)
    ys = np.clip(centers[:, 1:] - h // 2 + np.arange(h), 0, height - 1)  # (N, h)
    ii = np.arange(len(counts))[:, None, None]
    counts[ii, ys[:, :, None], xs[:, None, :]] += 1
    if quality is not None and qmap is not None:
        q = np.clip(np.asarray(quality, dtype=np.float64), 0, 1).reshape(-1)
        qmap[ii, ys[:, :, None], xs[:, None, :]] = (
            q.reshape(-1, 1, 1) if q.size > 1 else q[0]
        )


def visitation_overlay(counts, qmap, visited_opacity, unvisited_opacity):
    """(..., H', W') canvases -> (..., H', W', 4) uint8 RGBA overlay: visited
    cells get the red->green quality lerp at ``visited_opacity``, unvisited
    cells are black at ``unvisited_opacity`` (module.py:348-367 quantization:
    int-truncated opacities, rounded color)."""
    from .style import quality_colors

    visited = np.asarray(counts) > 0
    rgb = np.where(visited[..., None], quality_colors(qmap), 0)
    alpha = np.where(
        visited, int(255 * visited_opacity), int(255 * unvisited_opacity)
    )
    return np.concatenate([rgb, alpha[..., None]], axis=-1).astype(np.uint8)


def blend_overlay(frame_rgb, overlay_rgba):
    """Manual alpha blend of an RGBA overlay onto an RGB uint8 frame with the
    reference's truncating uint8 cast (module.py:375-385; PIL's
    alpha_composite needs RGBA bases, which break rectangle drawing)."""
    alpha = overlay_rgba[..., -1:] / 255
    mixed = np.asarray(frame_rgb) * (1 - alpha) + alpha * overlay_rgba[..., :-1]
    return mixed.astype(np.uint8)


def upscale_to_rgb(img01, render_size):
    """[0,1] float image (H, W) or (H, W, 3) -> nearest-upscaled RGB PIL
    frame of ``render_size`` (the base layer of every image-env frame)."""
    import PIL.Image

    return (
        _to_pil((np.asarray(img01) * 255).astype(np.uint8))
        .resize(tuple(render_size), resample=PIL.Image.NEAREST)
        .convert("RGB")
    )


def outlined_box(draw, coords_tlbr, outline, width, shadow=False):
    """Outlined rectangle, optionally with the (0, 0, 0, 80) drop shadow the
    reference offsets by one border width (module.py:387-398)."""
    if shadow:
        draw.rectangle(tuple(coords_tlbr + width), outline=(0, 0, 0, 80), width=width)
    draw.rectangle(tuple(coords_tlbr), outline=outline, width=width)


def render_image_perception(
    image: np.ndarray,
    pos_norm: np.ndarray,
    sensor_size,
    sensor_scale: float = 1.0,
    tracker: RenderTracker | None = None,
    target_norm: np.ndarray | None = None,
    pred_norm: np.ndarray | None = None,
    visited_opacity: float = 0.3,
    unvisited_opacity: float = 0.0,
) -> np.ndarray:
    """One env's frame: (H', W', 3) uint8."""
    import PIL.ImageDraw

    img = np.asarray(image)
    if img.shape[-1] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    render_size, scaling, eff, lim = _render_geometry(
        (h, w), sensor_size, sensor_scale
    )
    import PIL.Image

    base = (
        _to_pil((np.clip(img, 0, 1) * 255).astype(np.uint8))
        .resize(render_size, resample=PIL.Image.NEAREST)
        .convert("RGB")
    )

    if tracker is not None and tracker.visitation is not None:
        # Overlay composited exactly like the reference (module.py:348-385):
        # the RGBA overlay is quantized to uint8 FIRST, then manually
        # alpha-blended with a truncating cast.
        ol = visitation_overlay(
            tracker.visitation, tracker.quality_map,
            visited_opacity, unvisited_opacity,
        )
        base = _to_pil(blend_overlay(np.asarray(base, dtype=np.float64), ol))

    draw = PIL.ImageDraw.Draw(base, "RGBA")
    half = eff * scaling / 2
    bw = _glimpse_border_width(render_size)

    def box(center_norm, outline, shadow=False):
        c = _to_render_coords(np.asarray(center_norm), render_size, scaling, lim)
        outlined_box(draw, np.concatenate([c - half, c + half]), outline, bw, shadow)

    if target_norm is not None:
        box(target_norm, COLOR_PRED + (100,))
    if pred_norm is not None:
        box(pred_norm, COLOR_PRED, shadow=True)
    box(pos_norm, COLOR_AGENT, shadow=True)
    return np.asarray(base)


def render_light_dark(
    pos: np.ndarray,
    params,
    tracker: RenderTracker | None = None,
    resolution: int = 500,
) -> np.ndarray:
    """Brightness field + agent/obs/pred markers (light_dark.py:155-247)."""
    import PIL.ImageDraw
    import torch

    from ..envs.light_dark import brightness, obs_std

    params = _cpu_light_dark_params(params)
    xs = np.linspace(-1, 1, resolution, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    grid = np.stack([gx, gy], axis=-1)
    b = brightness(torch.from_numpy(grid), params, fused=False).numpy()
    img = _to_pil(((b * 0.9 + 0.1) * 255).astype(np.uint8)).convert("RGB")
    draw = PIL.ImageDraw.Draw(img, "RGBA")
    size = np.array(img.size)
    dot = 0.01 * img.size[0]

    def to_px(p):
        return (np.asarray(p) + 1) / 2 * size

    std = float(obs_std(torch.from_numpy(np.asarray(pos, np.float32)), params, fused=False))
    p_px = to_px(pos)
    r = std / 2 * size
    draw.ellipse(
        [tuple(p_px - r), tuple(p_px + r)], fill=COLOR_OBS_PRIMARY + (30,)
    )

    if tracker is not None:
        traj = tracker.trajectory
        for (pa, _), (pb, qb) in zip(traj[:-1], traj[1:]):
            draw.line(
                (*to_px(pa), *to_px(pb)), width=2, fill=quality_color(qb)
            )
        if tracker.last_obs is not None:
            o_px = to_px(tracker.last_obs)
            draw.line((*p_px, *o_px), fill=COLOR_OBS_PRIMARY + (80,))
            draw.ellipse(
                [tuple(o_px - dot), tuple(o_px + dot)],
                fill=COLOR_OBS_PRIMARY + (100,),
            )
        if tracker.last_pred is not None and tracker.last_pos is not None:
            lp, lq = to_px(tracker.last_pred), to_px(tracker.last_pos)
            draw.line((*lq, *lp), fill=COLOR_PRED + (80,))
            draw.ellipse([tuple(lp - dot), tuple(lp + dot)], fill=COLOR_PRED + (100,))
            draw.ellipse([tuple(lq - dot), tuple(lq + dot)], fill=COLOR_AGENT + (100,))
    draw.ellipse([tuple(p_px - dot), tuple(p_px + dot)], fill=COLOR_AGENT)
    return np.asarray(img)


def _cpu_light_dark_params(params):
    """LightDark params whose tensors (the light position) lie on the CPU."""
    import dataclasses

    import torch

    if params.device.type == "cpu":
        return params
    return dataclasses.replace(params, device=torch.device("cpu"))


def render_lidar(
    occ: np.ndarray,
    pos: np.ndarray,
    lidar_distances: np.ndarray | None,
    lidar_range: float,
    beam_count: int,
    tracker: RenderTracker | None = None,
    width: int = 500,
) -> np.ndarray:
    """Map + fog-of-war + beams + markers (lidar_localization2d.py:391-494)."""
    import PIL.Image
    import PIL.ImageDraw

    occ = np.asarray(occ, dtype=bool)
    scale = width / occ.shape[1]
    obs_map = (
        tracker.observation_map
        if tracker is not None and tracker.observation_map is not None
        else np.zeros_like(occ)
    )
    alpha = 0.25 + 0.75 * obs_map.astype(np.float32)
    base = (
        PIL.Image.fromarray(
            ((alpha * (~occ).astype(np.float32) + (1 - alpha) * 0.5) * 255).astype(
                np.uint8
            )
        )
        .resize(
            (int(round(occ.shape[1] * scale)), int(round(occ.shape[0] * scale))),
            resample=PIL.Image.NEAREST,
        )
        .convert("RGB")
    )
    draw = PIL.ImageDraw.Draw(base, "RGBA")
    marker_r = 0.2
    pos = np.asarray(pos, dtype=np.float64)

    if tracker is not None:
        traj = tracker.trajectory
        for (pa, _), (pb, qb) in zip(traj[:-1], traj[1:]):
            draw.line(
                (pa[0] * scale, pa[1] * scale, pb[0] * scale, pb[1] * scale),
                width=2,
                fill=quality_color(qb),
            )

    if lidar_distances is not None:
        ang = np.linspace(-np.pi, np.pi, beam_count, endpoint=False)
        dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
        for dist, d in zip(np.asarray(lidar_distances), dirs):
            contact = pos + d * dist
            draw.line(
                (pos[0] * scale, pos[1] * scale, contact[0] * scale, contact[1] * scale),
                width=2,
                fill=COLOR_OBS_PRIMARY,
            )
            draw.ellipse(
                (
                    (contact[0] - marker_r) * scale,
                    (contact[1] - marker_r) * scale,
                    (contact[0] + marker_r) * scale,
                    (contact[1] + marker_r) * scale,
                ),
                fill=COLOR_OBS_SECONDARY,
            )

    if tracker is not None and tracker.last_pred is not None:
        lp = np.asarray(tracker.last_pred)
        lq = np.asarray(tracker.last_pos if tracker.last_pos is not None else pos)
        draw.line(
            (lq[0] * scale, lq[1] * scale, lp[0] * scale, lp[1] * scale),
            fill=COLOR_PRED + (80,),
        )
        for c, col in ((lp, COLOR_PRED), (lq, COLOR_AGENT + (100,))):
            draw.ellipse(
                (
                    (c[0] - marker_r) * scale,
                    (c[1] - marker_r) * scale,
                    (c[0] + marker_r) * scale,
                    (c[1] + marker_r) * scale,
                ),
                fill=col,
            )

    draw.ellipse(
        (
            (pos[0] - marker_r) * scale,
            (pos[1] - marker_r) * scale,
            (pos[0] + marker_r) * scale,
            (pos[1] + marker_r) * scale,
        ),
        fill=COLOR_AGENT,
    )
    return np.asarray(base)


def _env0(x) -> np.ndarray:
    """Env 0 of a batched tensor (or array) as a host array."""
    if hasattr(x, "detach"):
        return x[0].detach().cpu().numpy()
    return np.asarray(x)[0]


def render_env(base_env, state, params, tracker: RenderTracker | None = None):
    """Dispatch on the env family; renders env 0 of the port's batched
    state. Returns (H', W', 3) uint8."""
    from ..compat.builders import unwrap_state
    from ..envs.image_classification import ImageClassificationEnv
    from ..envs.image_localization import ImageLocalizationEnv
    from ..envs.image_perception import ImagePerceptionEngine
    from ..envs.lidar_localization import LIDARLocalizationEnv
    from ..envs.light_dark import LightDarkEnv

    s = unwrap_state(state)

    if isinstance(base_env, ImageClassificationEnv):
        img, pos = _env0(ImagePerceptionEngine.image_raw(s, params)), _env0(s.pos)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return render_image_perception(
            img, pos, params.sensor_size, params.sensor_scale,
            tracker if params.display_visitation else None,
            visited_opacity=params.render_visited_opacity,
            unvisited_opacity=params.render_unvisited_opacity,
        )
    if isinstance(base_env, ImageLocalizationEnv):
        img = _env0(ImagePerceptionEngine.image_raw(s.perception, params))
        pos = _env0(s.perception.pos)
        target = _env0(s.target)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return render_image_perception(
            img,
            pos,
            params.sensor_size,
            params.sensor_scale,
            tracker if params.display_visitation else None,
            target_norm=target,
            pred_norm=(np.asarray(tracker.last_pred)
                       if tracker and tracker.last_pred is not None else None),
            visited_opacity=params.render_visited_opacity,
            unvisited_opacity=params.render_unvisited_opacity,
        )
    if isinstance(base_env, LightDarkEnv):
        return render_light_dark(_env0(s.pos), params, tracker)
    if isinstance(base_env, LIDARLocalizationEnv):
        occ, pos = _env0(s.occ), _env0(s.pos)
        last_lidar = tracker.last_lidar if tracker is not None else None
        return render_lidar(
            occ, pos, last_lidar, params.lidar_range, params.lidar_beam_count, tracker
        )
    raise TypeError(f"No renderer for {type(base_env).__name__}")
