"""Small geometric ops shared by the envs (counterpart of apx.ops.geometry)."""

from __future__ import annotations

import torch

from ..core.numerics import sqrt, sum_squares

__all__ = ["norm2", "project_sphere"]


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
