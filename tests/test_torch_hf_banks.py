"""The port's HF image banks against apx's: the synthetic generator bitwise
(bytes and labels, every corpus and split, class filters), the ingestion of
in-memory ``datasets`` fixtures (grayscale to RGB, the filter remap, float
images unscaled, channel checks), the offline probe's hygiene, the bank
kind, and the converters."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins the cpu backend)
from apx.data.huggingface import bank_from_hf as jax_bank_from_hf
from apx.data.huggingface import synthetic_image_bank as jax_synthetic

from apx_torch.convert import hf_bank_from_numpy
from apx_torch.data import huggingface as hf
from apx_torch.data.huggingface import CIFAR10_CLASSES, bank_from_hf, synthetic_image_bank

torch.set_num_threads(1)


def _apx_bytes(bank) -> tuple[np.ndarray, np.ndarray]:
    return np.asarray(bank.images_unpacked), np.asarray(bank.labels).astype(np.int64)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("name,filter_labels,channels", [
    ("mnist", None, None),
    ("mnist", None, 3),
    ("cifar10", None, None),
    ("cifar10", list(CIFAR10_CLASSES[:2]), None),
    ("cifar10", list(CIFAR10_CLASSES), None),
    ("zh-plus/tiny-imagenet", None, None),
])
def test_synthetic_bank_bitwise_equal_to_apx(name, filter_labels, channels, split):
    split = "valid" if name == "zh-plus/tiny-imagenet" and split == "test" else split
    ours = synthetic_image_bank(name, split, channels=channels, filter_labels=filter_labels,
                                num_points=300, device="cpu")
    ref = jax_synthetic(name, split, channels=channels, filter_labels=filter_labels,
                        num_points=300)
    images, labels = _apx_bytes(ref)
    assert ours.images.dtype == torch.uint8 and ours.image_shape == tuple(ref.image_shape)
    np.testing.assert_array_equal(ours.images.numpy(), images)
    np.testing.assert_array_equal(ours.labels.numpy(), labels)
    assert ours.num_classes == ref.num_classes
    assert ours.bank_kind == "synthetic" == ref._bank_kind


def test_synthetic_bank_default_size():
    """min(split size, 8192) images, as apx; a converted apx bank keeps its
    kind."""
    ours = synthetic_image_bank("zh-plus/tiny-imagenet", "valid", device="cpu")
    ref = jax_synthetic("zh-plus/tiny-imagenet", "valid")
    assert ours.length == ref.length == 8192
    np.testing.assert_array_equal(ours.labels.numpy(), np.asarray(ref.labels))
    conv = hf_bank_from_numpy(np.asarray(ref.images), np.asarray(ref.labels), ref.n_classes,
                              ref._bank_kind, packed_shape=ref.packed_shape, device="cpu")
    assert conv.bank_kind == "synthetic"
    assert torch.equal(conv.images, ours.images) and torch.equal(conv.labels, ours.labels)
    idx = torch.tensor([0, 5, 8191])
    assert torch.equal(ours.fetch_label(idx), ours.labels[idx])


datasets = pytest.importorskip("datasets")
PIL = pytest.importorskip("PIL")
import PIL.Image  # noqa: E402


def _fixture(channels=1, n=10, num_classes=4, hw=(9, 7), seed=0):
    """DatasetDict with train/test splits of tiny deterministic images."""
    rng = np.random.default_rng(seed)
    names = [f"cls{i}" for i in range(num_classes)]
    feats = datasets.Features({"image": datasets.Image(),
                               "label": datasets.ClassLabel(names=names)})

    def split(count, off):
        arrs = [rng.integers(0, 256, (*hw, channels), dtype=np.uint8) for _ in range(count)]
        if channels == 1:
            arrs = [a[..., 0] for a in arrs]
        imgs = [PIL.Image.fromarray(a) for a in arrs]
        labels = [(i + off) % num_classes for i in range(count)]
        return datasets.Dataset.from_dict({"image": imgs, "label": labels}, features=feats)

    return datasets.DatasetDict({"train": split(n, 0), "test": split(4, 1)})


def _same_bank(ours, ref):
    images, labels = _apx_bytes(ref)
    assert ours.num_classes == ref.num_classes and ours.length == ref.length
    assert ours.images.dtype == (torch.uint8 if images.dtype == np.uint8 else torch.float32)
    np.testing.assert_array_equal(ours.images.numpy(), images)
    np.testing.assert_array_equal(ours.labels.numpy(), labels)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("channels", [1, 3])
def test_bank_from_hf_matches_apx(split, channels):
    dd = _fixture(channels=1)  # a grayscale source: channels=3 repeats it to RGB
    ours = bank_from_hf(dd, split=split, channels=channels, device="cpu")
    _same_bank(ours, jax_bank_from_hf(dd, split=split, channels=channels))
    assert ours.bank_kind == "huggingface"


def test_filter_labels_match_apx():
    dd = _fixture(channels=3, n=12, num_classes=4)
    filt = ["cls2", "cls0"]  # out of order on purpose: the remap follows the filter
    ours = bank_from_hf(dd, channels=3, filter_labels=filt, device="cpu")
    _same_bank(ours, jax_bank_from_hf(dd, channels=3, filter_labels=filt))
    assert ours.num_classes == 2


def test_float_images_not_rescaled():
    rng = np.random.default_rng(3)
    imgs = [rng.uniform(0, 1, (5, 5, 3)).astype(np.float32) for _ in range(4)]
    feats = datasets.Features({"image": datasets.Array3D((5, 5, 3), "float32"),
                               "label": datasets.ClassLabel(names=["x", "y"])})
    ds = datasets.Dataset.from_dict({"image": [i.tolist() for i in imgs], "label": [0, 1, 0, 1]},
                                    features=feats)
    dd = datasets.DatasetDict({"train": ds})
    ours = bank_from_hf(dd, channels=3, device="cpu")
    assert ours.images.dtype == torch.float32
    _same_bank(ours, jax_bank_from_hf(dd, channels=3))
    np.testing.assert_array_equal(ours.images[2].numpy(), imgs[2])


def test_channel_mismatch_raises():
    with pytest.raises(ValueError, match="channels"):
        bank_from_hf(_fixture(channels=3), channels=1, device="cpu")
    with pytest.raises(ValueError, match="channels"):
        bank_from_hf(_fixture(channels=1), channels=2, device="cpu")


def test_offline_probe_restores_environ_and_flags(monkeypatch):
    """The probe removes the variables it set and restores the runtime
    flags it forced, and ``num_points`` cuts a loaded corpus to a prefix."""
    import os

    import huggingface_hub.constants as hub_constants
    from datasets import config as ds_config

    monkeypatch.delenv("HF_HUB_OFFLINE", raising=False)
    monkeypatch.delenv("HF_DATASETS_OFFLINE", raising=False)
    before = (hub_constants.HF_HUB_OFFLINE, ds_config.HF_HUB_OFFLINE)
    dd = _fixture(channels=1, n=12)
    monkeypatch.setattr("datasets.load_dataset", lambda *a, **k: dd)
    full = hf.load_hf_image_bank("whatever", channels=1, synthetic=False, device="cpu")
    cut = hf.load_hf_image_bank("whatever", channels=1, num_points=5, synthetic=False,
                                device="cpu")
    assert full.length == 12 and cut.length == 5 and cut.bank_kind == "huggingface"
    assert torch.equal(cut.images, full.images[:5])
    assert "HF_HUB_OFFLINE" not in os.environ and "HF_DATASETS_OFFLINE" not in os.environ
    assert (hub_constants.HF_HUB_OFFLINE, ds_config.HF_HUB_OFFLINE) == before


def test_cache_miss_falls_back_to_synthetic(monkeypatch):
    """A corpus that is not in the cache gives the synthetic bank under
    "auto" and raises under ``synthetic=False``."""
    def miss(*args, **kwargs):
        raise FileNotFoundError("not cached")

    monkeypatch.setattr("datasets.load_dataset", miss)
    bank = hf.load_hf_image_bank("mnist", num_points=16, device="cpu")
    assert bank.bank_kind == "synthetic" and bank.length == 16
    with pytest.raises(FileNotFoundError):
        hf.load_hf_image_bank("mnist", synthetic=False, device="cpu")
    assert hf.load_hf_image_bank("mnist", synthetic=True, num_points=4,
                                 device="cpu").bank_kind == "synthetic"
