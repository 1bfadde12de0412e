"""Render palette (counterpart of apx.render.style; a behavioral mirror of
the reference's style.py)."""

from __future__ import annotations

import numpy as np

COLOR_AGENT = (0, 85, 255)
COLOR_OBS_PRIMARY = (55, 255, 0)
COLOR_OBS_SECONDARY = (255, 55, 0)
COLOR_PRED = (200, 0, 200)
COLOR_GOOD = (0, 200, 0)
COLOR_BAD = (200, 0, 0)


def quality_color(quality) -> tuple[int, int, int]:
    """Red -> green lerp by prediction quality (style.py:13-19). The cast
    TRUNCATES like the reference's astype(np.int_)."""
    q = float(np.clip(quality, 0, 1))
    return tuple(
        int(q * g + (1 - q) * b) for g, b in zip(COLOR_GOOD, COLOR_BAD)
    )


def quality_colors(quality: np.ndarray) -> np.ndarray:
    """Array form of :func:`quality_color`: (...,) qualities -> (..., 3)
    integer RGB, float64 lerp with a truncating cast (identical quantization
    to the scalar form and to the reference's array math, style.py:13-19)."""
    q = np.clip(np.asarray(quality, dtype=np.float64), 0, 1)[..., None]
    return (q * np.array(COLOR_GOOD) + (1 - q) * np.array(COLOR_BAD)).astype(np.int_)
