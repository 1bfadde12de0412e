"""HuggingFace image corpora as device banks (counterpart of
apx.data.huggingface).

A corpus is packed once, when its env is built, into an unpacked
(D, H, W, C) uint8 ``BankImageDataset`` on the device (``dataset.py``
says why the port does not pack rows into int32 words); the glimpse divides
by 255 on read. The rules are ap_gym's and apx's: split selection,
``filter_labels`` subsetting with the labels renumbered in filter order,
HW -> HWC, grayscale repeated to RGB when the env wants three channels,
float images kept as they are.

No download happens here. ``load_hf_image_bank`` follows apx's offline
rule, controlled by ``synthetic``:

* ``"auto"`` (default): the local HF cache if ``datasets`` is importable
  and holds the corpus, else apx's deterministic synthetic bank with the
  corpus' geometry;
* ``True``: always synthetic;  ``False``: raise if the cache misses.

``bank.bank_kind`` is ``"huggingface"`` or ``"synthetic"``. ``datasets``
is imported only inside ``load_hf_image_bank``: ``import apx_torch`` works
without it, and a machine without it always gets the synthetic banks.
``synthetic_image_bank`` is apx's generator, copied: its bytes and labels
are bitwise apx's.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Sequence

import numpy as np

from .dataset import BankImageDataset

__all__ = [
    "CIFAR10_CLASSES",
    "HF_DATASET_GEOMETRY",
    "bank_from_hf",
    "load_hf_image_bank",
    "synthetic_image_bank",
]


@dataclasses.dataclass(frozen=True)
class _Geometry:
    image_hw: tuple[int, int]
    channels: int
    num_classes: int
    split_sizes: dict  # split -> count
    class_names: tuple[str, ...] | None = None


CIFAR10_CLASSES = (
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
)

HF_DATASET_GEOMETRY: dict[str, _Geometry] = {
    "mnist": _Geometry((28, 28), 1, 10, {"train": 60000, "test": 10000}),
    "cifar10": _Geometry((32, 32), 3, 10, {"train": 50000, "test": 10000}, CIFAR10_CLASSES),
    "zh-plus/tiny-imagenet": _Geometry((64, 64), 3, 200, {"train": 100000, "valid": 10000}),
}


def synthetic_image_bank(
    name: str,
    split: str = "train",
    channels: int | None = None,
    filter_labels: Sequence[str] | None = None,
    num_points: int | None = None,
    seed: int = 0,
    device="cuda",
) -> BankImageDataset:
    """apx's deterministic procedural stand-in with the corpus' geometry:
    class-dependent sinusoidal textures with per-sample phase and shift,
    ``min(split size, 8192)`` images unless ``num_points`` says otherwise.
    The generator is seeded from a crc32 of the name, not ``hash()``, so
    every process makes the same bank."""
    geo = HF_DATASET_GEOMETRY[name]
    h, w = geo.image_hw
    c = geo.channels if channels is None else channels
    k = geo.num_classes
    if filter_labels is not None:
        if geo.class_names is None:
            raise ValueError(f"{name} has no class names to filter by")
        k = len([geo.class_names.index(label) for label in filter_labels])
    n = num_points or min(geo.split_sizes.get(split, 8192), 8192)

    name_tag = zlib.crc32(name.encode()) & 0xFFFF
    rng = np.random.default_rng((seed, name_tag, 0 if split == "train" else 1))
    labels = rng.integers(0, k, size=n).astype(np.int32)
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1, 1, 1)).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, size=(n, 1, 1, 1)).astype(np.float32)

    yy = np.linspace(0, 1, h, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, None, :, None]
    cc = np.arange(c, dtype=np.float32)[None, None, None, :]
    freq = (labels[:, None, None, None] + 1).astype(np.float32)
    two_pi = np.float32(2 * np.pi)  # the whole pipeline stays float32
    # The image math is elementwise, so chunks of ~64 MB of float32 give
    # the whole-bank expression's bytes (the draws above are whole-bank).
    out = np.empty((n, h, w, c), dtype=np.uint8)
    step = max(1, (64 << 20) // (h * w * c * 4))
    for i in range(0, n, step):
        sl = slice(i, min(i + step, n))
        img = 0.5 + 0.25 * np.sin(
            two_pi * (freq[sl] * (xx + shift[sl]) + (cc + 1) * yy) + phase[sl],
            dtype=np.float32,
        ) + 0.25 * np.cos(two_pi * freq[sl] * yy + phase[sl], dtype=np.float32)
        img = np.clip(img, np.float32(0.0), np.float32(1.0))
        out[sl] = (img * 255).astype(np.uint8)
    return BankImageDataset.from_numpy(out, labels, num_classes=k, device=device,
                                       bank_kind="synthetic")


def _pack_hf_split(data, image_key: str, label_key: str, channels: int):
    """An HF split as (N, H, W, C) uint8-or-float32 images and (N,) int32
    labels, decoded column-wise (per row only for ragged images). uint8
    stays uint8, other dtypes become float32 unscaled, HW -> HWC, grayscale
    repeats to RGB when ``channels`` is 3."""
    cols = data.with_format("numpy", columns=[image_key, label_key])
    raw = cols[image_key]
    try:
        imgs = np.asarray(raw)
        if imgs.dtype == object:
            raise ValueError("ragged image column")
    except ValueError:
        imgs = np.stack([np.asarray(r) for r in raw])
    labels = np.asarray(cols[label_key]).astype(np.int32)
    if imgs.dtype != np.uint8 and imgs.dtype != np.float32:
        imgs = imgs.astype(np.float32)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    if channels not in (1, 3):
        raise ValueError(f"Target channels must be 1 or 3, got {channels}")
    if imgs.shape[-1] == 1 and channels == 3:
        imgs = np.repeat(imgs, 3, axis=-1)
    if imgs.shape[-1] != channels:
        raise ValueError(f"Expected {channels} channels but got {imgs.shape[-1]}")
    return imgs, labels


def _filter_hf_split(data, label_key: str, label_names, filter_labels):
    """The rows of the filtered classes and the lookup table that renumbers
    them 0..k-1 in ``filter_labels`` order (names resolved against the
    train split's ClassLabel, as the reference does)."""
    keep = [label_names.index(label) for label in filter_labels]
    lab = np.asarray(data[label_key])
    sel = np.where((lab[:, None] == np.asarray(keep)).any(axis=-1))[0]
    if len(sel) == 0:
        raise ValueError(
            f"filter_labels={list(filter_labels)!r} matched no rows in this "
            "split — a bank needs at least one image"
        )
    # The table covers the kept ids too, present in this split or not.
    lut = np.full(max(int(lab.max(initial=0)), max(keep)) + 1, -1, dtype=np.int32)
    lut[np.asarray(keep)] = np.arange(len(keep), dtype=np.int32)
    return data.select(sel), lut


def bank_from_hf(
    dataset_dict,
    split: str = "train",
    channels: int = 3,
    image_feature_name: str = "image",
    label_feature_name: str = "label",
    filter_labels: Sequence[str] | None = None,
    device="cuda",
) -> BankImageDataset:
    """An already-loaded HF DatasetDict as a device bank: the split, the
    ``filter_labels`` subset and remap, the packing. ``num_classes`` comes
    from the train split's label feature, or is ``len(filter_labels)``."""
    data = dataset_dict[split]
    train_features = dataset_dict["train"].features
    if filter_labels is not None:
        names = train_features[label_feature_name].names
        data, lut = _filter_hf_split(data, label_feature_name, names, list(filter_labels))
        imgs, labels = _pack_hf_split(data, image_feature_name, label_feature_name, channels)
        labels = lut[labels]
        k = len(list(filter_labels))
    else:
        imgs, labels = _pack_hf_split(data, image_feature_name, label_feature_name, channels)
        k = train_features[label_feature_name].num_classes
    return BankImageDataset.from_numpy(imgs, labels, num_classes=k, device=device,
                                       bank_kind="huggingface")


def load_hf_image_bank(
    name: str,
    split: str = "train",
    channels: int | None = None,
    image_feature_name: str = "image",
    label_feature_name: str = "label",
    filter_labels: Sequence[str] | None = None,
    synthetic: bool | str = "auto",
    num_points: int | None = None,
    device="cuda",
) -> BankImageDataset:
    """The corpus ``name`` from the local HF cache, or the synthetic bank
    (module docstring). ``num_points`` keeps the first rows of a loaded
    corpus, as it sizes the synthetic one. The offline probe leaves
    ``os.environ`` and the ``datasets``/``huggingface_hub`` flags as it
    found them."""
    geo = HF_DATASET_GEOMETRY.get(name)
    c = channels if channels is not None else (geo.channels if geo else 3)

    if synthetic is not True:
        saved: list[tuple] = []
        saved_env: list[str] = []
        try:
            # Set only the variables that are missing, and remove exactly
            # those again: a leftover HF_HUB_OFFLINE=1 would reach every
            # later subprocess.
            for var in ("HF_HUB_OFFLINE", "HF_DATASETS_OFFLINE"):
                if var not in os.environ:
                    os.environ[var] = "1"
                    saved_env.append(var)
            from datasets import load_dataset

            if os.environ.get("HF_HUB_OFFLINE") != "0":
                # The variables only count when `datasets` is first
                # imported; force the runtime flags too, so a cache miss
                # fails at once instead of retrying the network.
                import huggingface_hub.constants as hub_constants
                from datasets import config as ds_config

                saved.append((ds_config, "HF_HUB_OFFLINE", ds_config.HF_HUB_OFFLINE))
                ds_config.HF_HUB_OFFLINE = True
                if hasattr(ds_config, "HF_DATASETS_OFFLINE"):
                    saved.append((ds_config, "HF_DATASETS_OFFLINE", ds_config.HF_DATASETS_OFFLINE))
                    ds_config.HF_DATASETS_OFFLINE = True
                saved.append((hub_constants, "HF_HUB_OFFLINE", hub_constants.HF_HUB_OFFLINE))
                hub_constants.HF_HUB_OFFLINE = True

            bank = bank_from_hf(
                load_dataset(name), split=split, channels=c,
                image_feature_name=image_feature_name, label_feature_name=label_feature_name,
                filter_labels=filter_labels, device=device,
            )
            if num_points is not None and bank.length > num_points:
                bank = BankImageDataset(
                    images=bank.images[:num_points], labels=bank.labels[:num_points],
                    n_classes=bank.n_classes, bank_kind="huggingface",
                )
            return bank
        except Exception:
            if synthetic is False:
                raise
        finally:
            for obj, attr, val in saved:
                setattr(obj, attr, val)
            for var in saved_env:
                os.environ.pop(var, None)
    return synthetic_image_bank(name, split=split, channels=channels, filter_labels=filter_labels,
                                num_points=num_points, device=device)
