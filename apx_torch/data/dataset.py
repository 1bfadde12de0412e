"""Device-resident image datasets (counterpart of apx.data.dataset).

The whole dataset lives in device memory and ``fetch`` is a batched index
into it. uint8 banks stay uint8 ``(D, H, W, C)`` tensors; the glimpse
divides by 255 on read. apx stores uint8 rows packed into int32 words, a
measure against the TPU's per-element gather cost that has no counterpart
here (and torch has no shifts on uint32); ``apx_torch.convert`` unpacks
apx's words on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.numerics import div

__all__ = ["ImageDataset", "BankImageDataset"]


class ImageDataset:
    """Base: concrete datasets implement ``fetch_raw(idx) -> (image, label)``
    in the bank's storage dtype (uint8 for real image corpora)."""

    @property
    def length(self) -> int:
        raise NotImplementedError

    @property
    def num_classes(self) -> int:
        raise NotImplementedError

    @property
    def image_shape(self) -> tuple[int, int, int]:
        """(H, W, C)."""
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def fetch_raw(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def fetch(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(images as float32 in [0, 1] for uint8 banks, labels)."""
        img, label = self.fetch_raw(idx)
        if img.dtype == torch.uint8:
            return div(img.to(torch.float32), 255.0), label
        return img.to(torch.float32), label


class BankImageDataset(ImageDataset):
    """Fully materialized dataset: ``images`` (D, H, W, C) uint8 or float32
    and ``labels`` (D,) int64, on one device. ``bank_kind`` says where the
    images came from: ``"huggingface"`` (a loaded corpus), ``"synthetic"``
    (apx's procedural stand-in, ``data.huggingface``) or None (built by the
    caller)."""

    def __init__(self, images: torch.Tensor, labels: torch.Tensor, n_classes: int,
                 bank_kind: str | None = None):
        if images.ndim != 4 or images.dtype not in (torch.uint8, torch.float32):
            raise ValueError("images must be (D, H, W, C) uint8 or float32")
        if labels.shape != images.shape[:1]:
            raise ValueError("labels must be (D,)")
        self.images = images
        self.labels = labels.to(torch.int64)
        self.n_classes = int(n_classes)
        self.bank_kind = bank_kind

    @property
    def length(self) -> int:
        return int(self.images.shape[0])

    @property
    def num_classes(self) -> int:
        return self.n_classes

    @property
    def image_shape(self) -> tuple[int, int, int]:
        return tuple(int(s) for s in self.images.shape[1:])  # type: ignore[return-value]

    @property
    def device(self) -> torch.device:
        return self.images.device

    def fetch_raw(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.images[idx], self.labels[idx]

    def fetch_label(self, idx: torch.Tensor) -> torch.Tensor:
        return self.labels[idx]

    @staticmethod
    def from_numpy(images: np.ndarray, labels: np.ndarray, num_classes: int,
                   device="cuda", bank_kind: str | None = None) -> "BankImageDataset":
        """From host arrays: (D, H, W) gains a channel axis; uint8 stays
        uint8, anything else becomes float32."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[..., None]
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        return BankImageDataset(
            images=torch.from_numpy(np.array(images, copy=True, order="C")).to(device),
            labels=torch.from_numpy(np.asarray(labels).astype(np.int64)).to(device),
            n_classes=num_classes,
            bank_kind=bank_kind,
        )
