"""Procedural CircleSquare bank (counterpart of the single-object part of
apx.data.circle_square).

CircleSquare enumerates every (label, pos_x, pos_y) combination with a
mixed-radix index (ap_gym's circle_square_dataset). The bank is small
(2 * W * H images) and is made once on the host with numpy code copied from
apx, so images and labels are bitwise apx's, then moved to the device as a
float32 ``BankImageDataset``. ``DoubleCircleSquare`` is not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import numpy as np

from .dataset import BankImageDataset

__all__ = ["make_circle_square_bank", "circle_square_object_position_and_label"]


def _image_coords(image_shape: tuple[int, int]) -> np.ndarray:
    return np.stack(
        np.meshgrid(np.arange(image_shape[0]), np.arange(image_shape[1]), indexing="ij"),
        axis=-1,
    )


def _draw_object_np(img: np.ndarray, coords: np.ndarray, position: np.ndarray, label: int,
                    extents: int) -> None:
    """Rasterize a square (label 0) or circle (label 1) of the given extents."""
    if label == 0:
        mask = (
            (position[0] - extents / 2 <= coords[:, :, 0])
            & (coords[:, :, 0] <= position[0] + extents / 2)
            & (position[1] - extents / 2 <= coords[:, :, 1])
            & (coords[:, :, 1] <= position[1] + extents / 2)
        )
    else:
        mask = np.linalg.norm(position - coords, axis=-1) <= extents / 2
    img[mask] = 1.0


def circle_square_object_position_and_label(
    idx: np.ndarray, image_shape: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """Mixed-radix unpack [2, W, H]: idx -> ((pos_y, pos_x), label)."""
    idx = np.asarray(idx)
    label = idx % 2
    rem = idx // 2
    pos_x = rem % image_shape[1]
    pos_y = rem // image_shape[1]
    return np.stack([pos_y, pos_x], axis=-1), label


def make_circle_square_bank(
    image_shape: tuple[int, int] = (28, 28),
    object_extents: int = 8,
    show_gradient: bool = True,
    device="cuda",
) -> BankImageDataset:
    """All 2 * W * H CircleSquare images as a float32 (D, H, W, 1) bank.

    Pixels are the reference generator's: the gradient
    ``1 - |pos - coords| / sqrt(H^2 + W^2)`` plus the rasterized object,
    computed in float64 and cast to float32."""
    h, w = image_shape
    n = 2 * w * h
    coords = _image_coords(image_shape)
    max_dist = np.sqrt(h * h + w * w)
    images = np.empty((n, h, w, 1), dtype=np.float32)
    positions, labels = circle_square_object_position_and_label(np.arange(n), image_shape)
    for i in range(n):
        pos = positions[i]
        if show_gradient:
            img = 1.0 - np.linalg.norm(pos - coords, axis=-1) / max_dist
        else:
            img = np.zeros(image_shape)
        _draw_object_np(img, coords, pos, int(labels[i]), object_extents)
        images[i, :, :, 0] = img.astype(np.float32)
    return BankImageDataset.from_numpy(images, labels, num_classes=2, device=device)
