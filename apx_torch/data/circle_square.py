"""Procedural CircleSquare datasets (counterpart of apx.data.circle_square).

CircleSquare enumerates every (label, pos_x, pos_y) combination with a
mixed-radix index (ap_gym's circle_square_dataset). The bank is small
(2 * W * H images) and is made once on the host with numpy code copied from
apx, so images and labels are bitwise apx's, then moved to the device as a
float32 ``BankImageDataset``.

DoubleCircleSquare enumerates (label1, label2, position pair) over the
~2.3e5 valid pairs of a 28x28 image; as a bank that would be gigabytes, so,
as in apx, ``fetch_raw`` synthesizes the images on the device from the
index. The pairs are made on the host with apx's numpy code (bitwise).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.numerics import fma, sqrt
from .dataset import BankImageDataset, ImageDataset

__all__ = [
    "make_circle_square_bank",
    "circle_square_object_position_and_label",
    "DoubleCircleSquareDataset",
    "double_circle_square_positions",
]


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


def double_circle_square_positions(image_shape: tuple[int, int],
                                   object_extents: int = 8) -> np.ndarray:
    """(V, 2, 2) int32: every ordered pair of object positions whose objects
    do not overlap, each unordered pair once (a <= b lexicographically)."""
    coords = _image_coords(image_shape).reshape(-1, 2)
    a = coords[:, None, :]
    b = coords[None, :, :]
    valid = (np.abs(a - b) >= object_extents + 1).any(axis=-1)
    lex = (a[..., 0] < b[..., 0]) | ((a[..., 0] == b[..., 0]) & (a[..., 1] <= b[..., 1]))
    valid &= lex
    ai, bi = np.where(valid)
    return np.stack([coords[ai], coords[bi]], axis=1).astype(np.int32)


def _distance(dr: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """``sqrt(dr^2 + dc^2)`` of integer offsets: the sum is exact, so
    contracted or not it is apx's; the root is correctly rounded."""
    return sqrt(dr * dr + dc * dc)


def _gradient(nearest: torch.Tensor, max_dist: float) -> torch.Tensor:
    """``1 - nearest / max_dist`` as apx's jitted fetch rounds it:
    ``fma(-nearest, f32(1 / max_dist), 1)``."""
    inv = float(np.float32(1.0) / np.float32(max_dist))
    return fma(nearest, -inv, 1.0)


class DoubleCircleSquareDataset(ImageDataset):
    """Two objects per image, synthesized on the device by ``fetch_raw``.
    The index is mixed-radix [2, 2, V]: label of the first object, label of
    the second, position pair. Classes: 0 two squares, 1 two circles, 2 one
    of each; ``length`` is 4 V.

    The pixels round as apx's jitted ``fetch`` rounds them (``_distance``,
    ``_gradient``): XLA turns the gradient's division by the constant
    ``max_dist`` into a reciprocal multiply and contracts it with the
    subtraction. The square's bounds ``pos +- extents / 2`` are exact."""

    def __init__(self, positions: torch.Tensor, image_hw: tuple[int, int],
                 object_extents: int = 8, show_gradient_a: bool = True,
                 show_gradient_b: bool = True):
        self.positions = positions.to(torch.int64)
        self.image_hw = tuple(int(s) for s in image_hw)
        self.object_extents = int(object_extents)
        self.show_gradient_a = bool(show_gradient_a)
        self.show_gradient_b = bool(show_gradient_b)

    @staticmethod
    def create(image_shape: tuple[int, int] = (28, 28), object_extents: int = 8,
               show_gradient_a: bool = True, show_gradient_b: bool = True,
               device="cuda") -> "DoubleCircleSquareDataset":
        pairs = double_circle_square_positions(image_shape, object_extents)
        return DoubleCircleSquareDataset(
            torch.from_numpy(pairs).to(device), image_shape, object_extents,
            show_gradient_a, show_gradient_b,
        )

    @property
    def length(self) -> int:
        return 4 * int(self.positions.shape[0])

    @property
    def num_classes(self) -> int:
        return 3

    @property
    def image_shape(self) -> tuple[int, int, int]:
        return (*self.image_hw, 1)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def fetch_raw(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, H, W, 1) float32 images and (N,) int64 labels of indices (N,)."""
        h, w = self.image_hw
        half = self.object_extents / 2
        idx = idx.to(torch.int64)
        label1 = idx % 2
        rem = idx // 2
        label2 = rem % 2
        pair = self.positions[rem // 2].to(torch.float32)  # (N, 2, 2) as (row, col)
        dev = pair.device
        rr = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        cc = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]

        d1 = _distance(rr - pair[:, 0, 0, None, None], cc - pair[:, 0, 1, None, None])
        d2 = _distance(rr - pair[:, 1, 0, None, None], cc - pair[:, 1, 1, None, None])
        ga = 1.0 if self.show_gradient_a else 0.0
        gb = 1.0 if self.show_gradient_b else 0.0
        img = _gradient(torch.minimum(d1 * ga, d2 * gb), float(np.sqrt(h * h + w * w)))

        def draw(img, p, label, d):
            square = ((p[:, 0, None, None] - half <= rr) & (rr <= p[:, 0, None, None] + half)
                      & (p[:, 1, None, None] - half <= cc) & (cc <= p[:, 1, None, None] + half))
            circle = d <= half
            return torch.where(torch.where((label == 0)[:, None, None], square, circle), 1.0, img)

        img = draw(img, pair[:, 0], label1, d1)
        img = draw(img, pair[:, 1], label2, d2)
        label = torch.where(label1 == label2, label1, 2)
        return img[..., None], label
