"""Device-resident image datasets (counterpart of apx.data.dataset).

The whole dataset lives in device memory and ``fetch`` is a batched index
into it. uint8 banks are ``(D, H, W, C)`` tensors by default; the glimpse
divides by 255 on read. apx stores uint8 rows packed into int32 words
(``(D, H*W*C/4)``, little-endian), a measure against the TPU's
per-element gather cost; the port keeps that form as an option
(``BankImageDataset.from_numpy(..., pack=True)``, or apx's words as they
are through ``apx_torch.convert``), unpacked by ``unpack_rows``. An int32
word tensor viewed as uint8 is the same bytes, so the card reads a packed
bank or a packed row with no copy (``glimpse_images``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.numerics import div

__all__ = ["ImageDataset", "BankImageDataset", "unpack_rows", "pack_rows_u8"]


def unpack_rows(words: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Unpack little-endian int32-packed byte rows (..., R) into uint8
    (..., *shape) with shifts and ``& 0xFF`` (apx's ``unpack_rows``): byte
    i of word j is element 4 j + i."""
    u8 = torch.stack([(words >> (8 * i)) & 0xFF for i in range(4)], dim=-1).to(torch.uint8)
    return u8.reshape(*words.shape[:-1], *shape)


def pack_rows_u8(images: torch.Tensor) -> torch.Tensor:
    """(..., R) int32 words of uint8 images (..., H, W, C) with H W C a
    multiple of 4: the bytes of each row reinterpreted, as numpy's
    ``.view(np.int32)`` packs apx's banks."""
    lead = images.shape[:-3]
    return images.contiguous().reshape(*lead, -1).view(torch.int32)


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

    def fetch_label(self, idx: torch.Tensor) -> torch.Tensor:
        return self.fetch_raw(idx)[1]

    def fetch_stored(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Rows in the dataset's storage form (int32 words for a uint8
        bank whose rows pack, see ``stored_packed_shape``); a procedural
        dataset synthesizes the image."""
        return self.fetch_raw(idx)

    @property
    def stored_packed_shape(self) -> tuple | None:
        """The logical (H, W, C) when ``fetch_stored`` gives int32 words,
        else None."""
        return None

    def glimpse_images(self) -> torch.Tensor | None:
        """The whole bank as (D, H, W, C) images in the logical dtype,
        without a copy, for a glimpse that reads bank rows by index; None
        for a procedural dataset."""
        return None

    def fetch(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(images as float32 in [0, 1] for uint8 banks, labels)."""
        img, label = self.fetch_raw(idx)
        if img.dtype == torch.uint8:
            return div(img.to(torch.float32), 255.0), label
        return img.to(torch.float32), label


class BankImageDataset(ImageDataset):
    """Fully materialized dataset: ``images`` (D, H, W, C) uint8 or float32,
    or with ``packed_shape`` = (H, W, C) the uint8 rows packed into (D, R)
    int32 words (apx's packed bank), and ``labels`` (D,) int64, on one
    device. ``bank_kind`` says where the images came from:
    ``"huggingface"`` (a loaded corpus), ``"synthetic"`` (apx's procedural
    stand-in, ``data.huggingface``) or None (built by the caller).

    A bank sharded across ranks (``distrib.shard_params(...,
    shard_leading=True)``) holds this rank's block of ``images`` and
    ``labels`` and a ``shard`` (``distrib.mesh.BankShard``); its fetches are
    then collectives that every rank makes together."""

    def __init__(self, images: torch.Tensor, labels: torch.Tensor, n_classes: int,
                 bank_kind: str | None = None, packed_shape: tuple | None = None):
        if packed_shape is not None:
            packed_shape = tuple(int(s) for s in packed_shape)
            if (images.ndim != 2 or images.dtype != torch.int32
                    or 4 * images.shape[1] != int(np.prod(packed_shape))):
                raise ValueError("a packed bank is (D, H*W*C/4) int32 words")
        elif images.ndim != 4 or images.dtype not in (torch.uint8, torch.float32):
            raise ValueError("images must be (D, H, W, C) uint8 or float32")
        if labels.shape != images.shape[:1]:
            raise ValueError("labels must be (D,)")
        self.images = images
        self.labels = labels.to(torch.int64)
        self.n_classes = int(n_classes)
        self.bank_kind = bank_kind
        self.packed_shape = packed_shape
        self.shard = None

    @property
    def length(self) -> int:
        return self.shard.num_rows if self.shard is not None else int(self.images.shape[0])

    def _take(self, idx: torch.Tensor, *leaves: torch.Tensor) -> list[torch.Tensor]:
        if self.shard is not None:
            return self.shard.take(idx, [(leaf, None) for leaf in leaves])
        return [leaf[idx] for leaf in leaves]

    def sharded(self, shard, block, whole) -> "BankImageDataset":
        """This rank's block [shard.lo, shard.hi) of the images and labels,
        ``block(leaf)``, with ``shard`` set (``whole`` is unused: every leaf
        has the bank axis; ``distrib.shard_params`` places the blocks)."""
        out = BankImageDataset(block(self.images), block(self.labels),
                               self.n_classes, self.bank_kind, self.packed_shape)
        out.shard = shard
        return out

    @property
    def num_classes(self) -> int:
        return self.n_classes

    @property
    def image_shape(self) -> tuple[int, int, int]:
        if self.packed_shape is not None:
            return self.packed_shape
        return tuple(int(s) for s in self.images.shape[1:])  # type: ignore[return-value]

    @property
    def device(self) -> torch.device:
        return self.images.device

    @property
    def stored_packed_shape(self) -> tuple | None:
        """The logical shape of a uint8 bank whose rows pack into int32
        words (H W C a multiple of 4), whichever form it is kept in: apx
        packs every such bank, so its ``image_storage="packed"`` applies to
        exactly these."""
        if self.packed_shape is not None:
            return self.packed_shape
        if self.images.dtype == torch.uint8 and int(np.prod(self.images.shape[1:])) % 4 == 0:
            return self.image_shape
        return None

    def glimpse_images(self) -> torch.Tensor | None:
        if self.shard is not None:  # the rows are read by collective fetches
            return None
        if self.packed_shape is None:
            return self.images
        return self.images.view(torch.uint8).reshape(self.length, *self.packed_shape)

    def fetch_raw(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        img, label = self._take(idx, self.images, self.labels)
        if self.packed_shape is not None:
            img = unpack_rows(img, self.packed_shape)
        return img, label

    def fetch_stored(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(..., R) int32 words of the rows at ``idx`` for a bank with a
        ``stored_packed_shape``, (..., H, W, C) images otherwise, and the
        labels."""
        img, label = self._take(idx, self.images, self.labels)
        if self.packed_shape is None and self.stored_packed_shape is not None:
            img = pack_rows_u8(img)
        return img, label

    def fetch_label(self, idx: torch.Tensor) -> torch.Tensor:
        return self._take(idx, self.labels)[0]

    @staticmethod
    def from_numpy(images: np.ndarray, labels: np.ndarray, num_classes: int,
                   device="cuda", bank_kind: str | None = None,
                   pack: bool = False) -> "BankImageDataset":
        """From host arrays: (D, H, W) gains a channel axis; uint8 stays
        uint8, anything else becomes float32. ``pack``: uint8 rows whose size
        divides by 4 are kept as int32 words (apx's form)."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[..., None]
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        shape = tuple(images.shape[1:])
        packed = None
        images = np.array(images, copy=True, order="C")
        if pack and images.dtype == np.uint8 and int(np.prod(shape)) % 4 == 0:
            images, packed = images.reshape(images.shape[0], -1).view(np.int32), shape
        return BankImageDataset(
            images=torch.from_numpy(images).to(device),
            labels=torch.from_numpy(np.asarray(labels).astype(np.int64)).to(device),
            n_classes=num_classes,
            bank_kind=bank_kind,
            packed_shape=packed,
        )
