"""Small geometric ops shared by the envs (counterpart of apx.ops.geometry)."""

from __future__ import annotations

import torch

from ..core.numerics import sqrt, sum_squares

__all__ = ["norm2", "normalize_into_unit_ball", "project_sphere"]


def norm2(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis as the jitted reference rounds
    ``jnp.linalg.norm``: ``sqrt(fma(y, y, x*x))``, correctly rounded."""
    return sqrt(sum_squares(x))


def project_sphere(x: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """Project x (..., D) into the ball of the given radius: points outside
    are scaled onto the sphere, points inside pass through
    (ap_gym.util.project_sphere)."""
    magnitude = norm2(x)[..., None]
    direction = x / torch.clamp_min(magnitude, radius)
    return torch.where(magnitude > radius, direction * radius, x)


def normalize_into_unit_ball(x: torch.Tensor) -> torch.Tensor:
    """x (..., D) divided by |x| where |x| > 1, else x (apx's
    ``normalize_into_unit_ball``; the LIDAR and LightDark moves). |x| is
    ``norm2``'s, and the division is a true division, as the jitted
    reference rounds both."""
    magnitude = norm2(x)[..., None]
    return torch.where(magnitude > 1.0, x / torch.where(magnitude == 0.0, 1.0, magnitude), x)
