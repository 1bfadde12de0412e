"""Reference-shaped host dataset classes for the ``ap_gym.envs.*`` surface
(counterpart of apx.compat.dataset_classes).

The reference exposes its data layer as a small class hierarchy
(``ap_gym.envs.dataset.Dataset`` ABC + ``ap_gym.envs.image`` /
``ap_gym.envs.floor_map`` concrete datasets) that users subclass and
compose with the iterator/prefetch machinery. The port's own data layer is
device banks (``apx_torch.data``), so these classes exist for drop-in
interop: same names, ctor signatures and data-point semantics as apx's,
over the port's numpy generators (copied from apx and pinned bitwise to
them). They return numpy arrays and need neither gymnasium nor a card.

This ``DoubleCircleSquareDataset`` is the host class of the reference; the
device-side dataset of the same name is
``apx_torch.data.circle_square.DoubleCircleSquareDataset``.

Behavioral citations are to the reference's ap_gym/envs/<path>:<lines>.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Iterable

import numpy as np

from ..data.circle_square import (
    _draw_object_np,
    _image_coords,
    circle_square_object_position_and_label,
    double_circle_square_positions,
)
from ..data.floor_map import generate_maze_map, generate_rooms_map

__all__ = [
    "Dataset",
    "ImageClassificationDataset",
    "CircleSquareDataset",
    "DoubleCircleSquareDataset",
    "HuggingfaceImageClassificationDataset",
    "FloorMapDataset",
    "FloorMapDatasetMaze",
    "FloorMapDatasetRooms",
]


class Dataset(ABC):
    """Indexable data source with int/sequence dispatch
    (dataset/dataset.py:12-43)."""

    def load(self):
        """Hook for deferred (e.g. network) loading; default no-op."""

    @abstractmethod
    def _get_length(self) -> int: ...

    @abstractmethod
    def get_data_point(self, idx): ...

    @abstractmethod
    def get_data_point_batch(self, idx): ...

    def __getitem__(self, item):
        # Anything sized (list/tuple/ndarray of indices) is a batch request;
        # bare ints and numpy integer scalars fetch a single point.
        if hasattr(item, "__len__"):
            return self.get_data_point_batch(item)
        return self.get_data_point(item)

    def __len__(self) -> int:
        return self._get_length()


def _normalize_image_batch(imgs: np.ndarray, target_channels: int) -> np.ndarray:
    """The reference's image normalization rules
    (image/image_classification_dataset.py:66-84): uint8 -> f32/255,
    other dtypes -> f32 passthrough, HW -> HWC, gray -> RGB repeat."""
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 255
    elif imgs.dtype != np.float32:
        imgs = imgs.astype(np.float32)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    if target_channels not in (1, 3):
        raise ValueError(
            f"Target channels must be either 1 or 3 but is {target_channels}."
        )
    if imgs.shape[-1] == 1 and target_channels == 3:
        imgs = np.repeat(imgs, 3, axis=-1)
    if imgs.shape[-1] != target_channels:
        raise ValueError(
            f"Invalid image format. Expected {target_channels} channels "
            f"but got {imgs.shape[-1]}"
        )
    return imgs


class ImageClassificationDataset(Dataset):
    """Image+label dataset with point<->batch auto-derivation and the
    normalization rules above (image/image_classification_dataset.py:12-98).

    Subclasses override ``_get_data_point`` and/or ``_get_data_point_batch``
    (raw, un-normalized); whichever is missing is derived from the other.
    """

    @abstractmethod
    def _get_num_classes(self) -> int: ...

    @abstractmethod
    def _get_num_channels(self) -> int: ...

    def _get_data_point(self, idx: int):
        raise NotImplementedError

    def _get_data_point_batch(self, idx: np.ndarray):
        raise NotImplementedError

    def get_data_point(self, idx):
        try:
            img, label = self._get_data_point(int(idx))
        except NotImplementedError:
            imgs, labels = self._batch_raw(np.array([int(idx)]))
            img, label = imgs[0], labels[0]
        return self._process(np.asarray(img)[None])[0], int(label)

    def get_data_point_batch(self, idx):
        idx = np.asarray(idx)
        if idx.shape[0] == 0:
            raise ValueError("Empty index array")
        imgs, labels = self._batch_raw(idx)
        if isinstance(imgs, np.ndarray):
            out = self._process(imgs)
        else:  # heterogeneous (e.g. PIL) entries: normalize one by one
            out = np.stack([self._process(np.asarray(im)[None])[0] for im in imgs])
        return out, np.asarray(labels).astype(np.int32)

    def _batch_raw(self, idx: np.ndarray):
        try:
            return self._get_data_point_batch(idx)
        except NotImplementedError:
            pass
        try:
            pairs = [self._get_data_point(int(i)) for i in idx]
        except NotImplementedError:
            raise TypeError(
                "At least one of _get_data_point or _get_data_point_batch "
                "must be implemented."
            ) from None
        imgs, labels = zip(*pairs)
        return list(imgs), list(labels)

    def _process(self, imgs: np.ndarray) -> np.ndarray:
        return _normalize_image_batch(imgs, self._get_num_channels())

    @property
    def num_classes(self) -> int:
        return self._get_num_classes()

    @property
    def num_channels(self) -> int:
        return self._get_num_channels()


class CircleSquareDataset(ImageClassificationDataset):
    """Procedural square-vs-circle images, fully enumerable: index packs
    (label, pos_x, pos_y) mixed-radix over [2, W, H]
    (image/circle_square_dataset.py:80-111). Pixel values are produced by
    the same generator the device banks use, bitwise apx's."""

    def __init__(
        self,
        show_gradient: bool = True,
        image_shape: tuple[int, int] = (28, 28),
        object_extents: int = 8,
    ):
        self._show_gradient = show_gradient
        self._image_shape = tuple(image_shape)
        self._object_extents = object_extents
        self._coords = _image_coords(self._image_shape)
        self._max_dist = float(np.sqrt(np.sum(np.asarray(self._image_shape) ** 2)))

    def _get_num_classes(self) -> int:
        return 2

    def _get_num_channels(self) -> int:
        return 1

    def _get_length(self) -> int:
        return 2 * self._image_shape[0] * self._image_shape[1]

    def get_object_position_and_label(self, idx):
        return circle_square_object_position_and_label(
            np.asarray(idx), self._image_shape
        )

    def _get_data_point(self, idx: int):
        position, label = self.get_object_position_and_label(idx)
        if self._show_gradient:
            img = 1 - np.linalg.norm(position - self._coords, axis=-1) / self._max_dist
        else:
            img = np.zeros(self._image_shape)
        _draw_object_np(img, self._coords, position, int(label), self._object_extents)
        return img[:, :, None], int(label)


class DoubleCircleSquareDataset(ImageClassificationDataset):
    """Two objects per image; classes 0/1 = both squares/circles, 2 = mixed.
    Index packs (label_1, label_2, pair_idx) over all valid non-overlapping
    position pairs (image/circle_square_dataset.py:114-178). Note the
    reference's -nograd quirk: a disabled gradient multiplies the distance
    field by False rather than removing it, which this reproduces by using
    the same formula."""

    def __init__(
        self,
        show_gradient_a: bool = True,
        show_gradient_b: bool = True,
        image_shape: tuple[int, int] = (28, 28),
        object_extents: int = 8,
    ):
        self._show_gradient_a = show_gradient_a
        self._show_gradient_b = show_gradient_b
        self._image_shape = tuple(image_shape)
        self._object_extents = object_extents
        self._coords = _image_coords(self._image_shape)
        self._max_dist = float(np.sqrt(np.sum(np.asarray(self._image_shape) ** 2)))
        self._positions = double_circle_square_positions(
            self._image_shape, object_extents
        )

    def _get_num_classes(self) -> int:
        return 3

    def _get_num_channels(self) -> int:
        return 1

    def _get_length(self) -> int:
        return 2 * 2 * len(self._positions)

    def _get_data_point(self, idx: int):
        label_1 = idx % 2
        rem = idx // 2
        label_2 = rem % 2
        pos_1, pos_2 = self._positions[rem // 2]
        img = (
            1
            - np.minimum(
                np.linalg.norm(pos_1 - self._coords, axis=-1) * self._show_gradient_a,
                np.linalg.norm(pos_2 - self._coords, axis=-1) * self._show_gradient_b,
            )
            / self._max_dist
        )
        for pos, label in ((pos_1, label_1), (pos_2, label_2)):
            _draw_object_np(img, self._coords, pos, int(label), self._object_extents)
        label = label_1 if label_1 == label_2 else 2
        return img[:, :, None], int(label)


class HuggingfaceImageClassificationDataset(ImageClassificationDataset):
    """HF-hub-backed dataset with split selection and optional label
    subsetting (image/huggingface_image_classification_dataset.py:13-80).
    ``filter_labels`` renumbers the selected classes 0..k-1 in the given
    order, resolved against the TRAIN split's ClassLabel names; unlike the
    reference (which rewrites rows via .map/.cast), the remap here is a
    lookup table applied at access time — observable data is identical."""

    def __init__(
        self,
        dataset_name: str,
        channels: int = 3,
        split: str = "train",
        image_feature_name: str = "image",
        label_feature_name: str = "label",
        filter_labels: Iterable[str] | None = None,
    ):
        self._dataset_name = dataset_name
        self._channels = channels
        self._split = split
        self._image_key = image_feature_name
        self._label_key = label_feature_name
        self._filter_labels = None if filter_labels is None else list(filter_labels)
        self._data = None
        self._num_classes = None
        self._label_lut = None

    def load(self):
        import aiohttp
        from datasets import load_dataset

        raw = load_dataset(
            self._dataset_name,
            storage_options={
                "client_kwargs": {"timeout": aiohttp.ClientTimeout(total=60 * 60 * 6)}
            },
        )
        data = raw[self._split]
        label_feature = raw["train"].features[self._label_key]
        if self._filter_labels is None:
            self._num_classes = label_feature.num_classes
            self._data = data
        else:
            from ..data.huggingface import _filter_hf_split

            self._data, self._label_lut = _filter_hf_split(
                data, self._label_key, label_feature.names, self._filter_labels
            )
            self._num_classes = len(self._filter_labels)

    def _get_num_classes(self) -> int:
        return self._num_classes

    def _get_num_channels(self) -> int:
        return self._channels

    def _get_length(self) -> int:
        return len(self._data)

    def _get_data_point(self, idx: int):
        row = self._data[idx]
        label = row[self._label_key]
        if self._label_lut is not None:
            label = int(self._label_lut[int(label)])
        return row[self._image_key], label


class FloorMapDataset(Dataset, ABC):
    """Boolean occupancy maps, True = wall (floor_map/floor_map_dataset.py:
    10-21). Virtually infinite: maps are generated from the data index."""

    def __init__(self, map_width: int, map_height: int):
        self._map_width = map_width
        self._map_height = map_height

    @property
    def map_width(self) -> int:
        return self._map_width

    @property
    def map_height(self) -> int:
        return self._map_height

    def get_data_point_batch(self, idx):
        return np.stack([self.get_data_point(i) for i in idx])

    def _get_length(self) -> int:
        return 2**32


class FloorMapDatasetMaze(FloorMapDataset):
    """Recursive-backtracker maze seeded by data index
    (floor_map/floor_map_dataset_maze.py:10-63); generation is delegated to
    the port's copy of apx's draw-sequence-identical generator."""

    def __init__(
        self, width: int = 21, height: int = 21, branching_prob: float = 1.0
    ):
        if width % 2 == 0 or height % 2 == 0:
            raise ValueError("Width and height must be odd.")
        super().__init__(width, height)
        self._branching_prob = branching_prob

    def get_data_point(self, idx) -> np.ndarray:
        return generate_maze_map(
            int(idx), self.map_width, self.map_height, self._branching_prob
        )


class FloorMapDatasetRooms(FloorMapDataset):
    """Recursive room splitting with doors, seeded by data index
    (floor_map/floor_map_dataset_rooms.py:10-97); generation is delegated
    to the port's copy of apx's draw-sequence-identical generator
    (including the random transpose)."""

    def __init__(
        self,
        width: int = 32,
        height: int = 32,
        max_rooms: int = 10,
        door_width: int = 3,
    ):
        super().__init__(width, height)
        self._max_rooms = max_rooms
        self._door_width = door_width

    def get_data_point(self, idx) -> np.ndarray:
        return generate_rooms_map(
            int(idx),
            self.map_width,
            self.map_height,
            self._max_rooms,
            self._door_width,
        )
