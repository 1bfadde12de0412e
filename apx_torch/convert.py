"""Carry apx's data across to the port: the port's counterpart of loading
weights. Every function takes numpy arrays (what ``np.asarray`` gives for
apx's JAX arrays) and a device.

* ``map_bank_from_numpy`` builds a ``MapBank`` from apx's bank arrays;
* ``lidar_state_from_numpy`` builds the vector state of a
  ``TimeLimit(LIDARLocalizationEnv)`` from apx's state leaves (with the
  bitslab backends' ``row_halves``);
* ``image_bank_from_numpy`` builds a ``BankImageDataset`` from apx's bank
  (int32-packed uint8 rows, unpacked or kept packed, uint8 or float32
  images);
* ``hf_bank_from_numpy`` is ``image_bank_from_numpy`` with apx's bank
  kind (``"huggingface"`` or ``"synthetic"``);
* ``double_circle_square_from_numpy`` builds a
  ``DoubleCircleSquareDataset`` from apx's position pairs and fields;
* ``image_state_from_numpy`` builds the vector state of an
  ``ImageClassificationEnv`` from apx's state leaves;
* ``image_localization_state_from_numpy`` builds the vector state of an
  ``ImageLocalizationEnv``;
* ``light_dark_state_from_numpy`` builds the vector state of a
  ``TimeLimit(LightDarkEnv)`` from apx's state leaves;
* ``metrics_state_from_numpy`` wraps a converted vector state in the
  metrics wrappers' state, from apx's ring buffers and counts;
* ``ppo_net_from_numpy`` and ``r2d2_net_from_numpy`` carry the training
  recipes' weights across: apx's nested dict of ``{"w", "b"}`` arrays
  (dense (in, out), convolutions HWIO) into the port's modules ((out, in),
  OIHW), the LSTM cell's ``wx``, ``wh`` and ``b`` as they are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.env import VectorState
from .data.circle_square import DoubleCircleSquareDataset
from .data.dataset import BankImageDataset
from .data.floor_map import MapBank, pack_rows
from .envs.image_localization import ImageLocalizationState
from .envs.image_perception import ImagePerceptionState
from .envs.lidar_localization import LIDARBitslabState, LIDARLocalizationState
from .envs.light_dark import LightDarkState
from .wrappers.metrics import MetricsState
from .wrappers.time_limit import TimeLimitState

__all__ = ["map_bank_from_numpy", "lidar_state_from_numpy", "image_bank_from_numpy",
           "hf_bank_from_numpy", "double_circle_square_from_numpy", "image_state_from_numpy",
           "image_localization_state_from_numpy", "light_dark_state_from_numpy",
           "metrics_state_from_numpy", "ppo_net_from_numpy", "r2d2_net_from_numpy"]


def _t(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(dtype=dtype, device=device)


def map_bank_from_numpy(maps, indices, free_counts, free_cells, device="cuda",
                        kind: str = "custom", beam_face=None, beam_axis=None) -> MapBank:
    """MapBank from apx's ``maps`` (M, H, W) bool, ``indices`` (M,) uint32,
    ``free_counts`` (M,) and ``free_cells`` (M, max_free), and its beam
    tables when it has them (``with_beam_tables``: ``beam_face`` (M, 8, 2,
    H, W) f32, ``beam_axis`` bool). The packed rows are rebuilt from
    ``maps`` (apx's are uint32, the port's int64)."""
    maps = np.asarray(maps, dtype=np.bool_)
    tables = {}
    if beam_face is not None:
        tables = dict(beam_face=_t(np.asarray(beam_face, np.float32), torch.float32, device),
                      beam_axis=_t(np.asarray(beam_axis, np.bool_), torch.bool, device))
    return MapBank(
        maps=_t(maps, torch.bool, device),
        indices=_t(np.asarray(indices).astype(np.int64), torch.int64, device),
        free_counts=_t(np.asarray(free_counts).astype(np.int64), torch.int64, device),
        row_words=_t(pack_rows(maps), torch.int64, device),
        free_cells=_t(np.asarray(free_cells).astype(np.int64), torch.int64, device),
        kind=kind,
        **tables,
    )


def lidar_state_from_numpy(occ, pos, initial_pos, odo_pending, bank_pos, map_idx,
                           t, prev_done, device="cuda", row_halves=None) -> VectorState:
    """Vector state of ``TimeLimit(LIDARLocalizationEnv)`` from apx's leaves
    (``state.inner.inner.*``, ``state.inner.t``, ``state.prev_done``), under
    any backend: the bitslab backends' ``row_halves`` (N, H, 2) int32 make a
    ``LIDARBitslabState``. apx's window backends also carry the ray-padded
    map, ``pad_occupancy(occ, ray_pad)``, which the port derives from
    ``occ`` and does not carry."""
    leaves = dict(
        occ=_t(np.asarray(occ, dtype=np.bool_), torch.bool, device),
        bank_pos=_t(np.asarray(bank_pos).astype(np.int64), torch.int64, device),
        map_idx=_t(np.asarray(map_idx).astype(np.int64), torch.int64, device),
        pos=_t(np.asarray(pos, dtype=np.float32), torch.float32, device),
        initial_pos=_t(np.asarray(initial_pos, dtype=np.float32), torch.float32, device),
        odo_pending=_t(np.asarray(odo_pending, dtype=np.bool_), torch.bool, device),
    )
    if row_halves is None:
        inner = LIDARLocalizationState(**leaves)
    else:
        inner = LIDARBitslabState(**leaves, row_halves=_t(np.asarray(row_halves, np.int32),
                                                          torch.int32, device))
    return VectorState(
        inner=TimeLimitState(inner=inner, t=_t(np.asarray(t).astype(np.int32), torch.int32, device)),
        prev_done=_t(np.asarray(prev_done, dtype=np.bool_), torch.bool, device),
    )


def image_bank_from_numpy(images, labels, num_classes: int, packed_shape=None,
                          device="cuda", pack: bool = False) -> BankImageDataset:
    """BankImageDataset from apx's ``images``, ``labels`` and ``n_classes``.
    With apx's ``packed_shape`` (H, W, C), ``images`` are its (D, R) int32
    words of packed uint8 rows: kept as they are with ``pack``, else
    unpacked on the host (their bytes); otherwise (D, H, W, C) uint8 or
    float32."""
    images = np.asarray(images)
    if packed_shape is not None:
        images = np.ascontiguousarray(images).view(np.uint8).reshape(
            (images.shape[0], *packed_shape))
    return BankImageDataset.from_numpy(images, labels, num_classes, device=device, pack=pack)


def hf_bank_from_numpy(images, labels, num_classes: int, bank_kind: str, packed_shape=None,
                       device="cuda", pack: bool = False) -> BankImageDataset:
    """``image_bank_from_numpy`` of an apx HF bank, with its kind (apx's
    ``_bank_kind``: ``"huggingface"`` or ``"synthetic"``)."""
    bank = image_bank_from_numpy(images, labels, num_classes, packed_shape, device, pack)
    bank.bank_kind = bank_kind
    return bank


def double_circle_square_from_numpy(positions, image_hw, object_extents: int,
                                    show_gradient_a: bool, show_gradient_b: bool,
                                    device="cuda") -> DoubleCircleSquareDataset:
    """DoubleCircleSquareDataset from apx's ``positions`` (V, 2, 2) and its
    static fields."""
    return DoubleCircleSquareDataset(
        _t(np.asarray(positions).astype(np.int64), torch.int64, device), image_hw,
        object_extents, show_gradient_a, show_gradient_b)


def _perception_state(image, label, data_index, pos, time, label_inverted,
                      device) -> ImagePerceptionState:
    image = np.asarray(image)
    dtype = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32}.get(
        image.dtype, torch.float32)
    return ImagePerceptionState(
        image=_t(image, dtype, device),
        label=_t(np.asarray(label).astype(np.int64), torch.int64, device),
        data_index=_t(np.asarray(data_index).astype(np.int64), torch.int64, device),
        pos=_t(np.asarray(pos, dtype=np.float32), torch.float32, device),
        time=_t(np.asarray(time).astype(np.int32), torch.int32, device),
        label_inverted=_t(np.asarray(label_inverted, dtype=np.bool_), torch.bool, device),
    )


def image_state_from_numpy(image, label, data_index, pos, time, label_inverted, prev_done,
                           device="cuda") -> VectorState:
    """Vector state of ``ImageClassificationEnv`` from apx's leaves
    (``state.inner.*`` and ``state.prev_done``). The image leaf is in the
    form of apx's ``image_storage``: (N, H, W, C) uint8 or float32, (N, R)
    int32 words ("packed"), (N, H*W*C) ("flat") or (N, 0) ("gather")."""
    inner = _perception_state(image, label, data_index, pos, time, label_inverted, device)
    return VectorState(inner=inner,
                       prev_done=_t(np.asarray(prev_done, dtype=np.bool_), torch.bool, device))


def image_localization_state_from_numpy(image, label, data_index, pos, time, label_inverted,
                                        target, target_glimpse, prev_done,
                                        device="cuda") -> VectorState:
    """Vector state of ``ImageLocalizationEnv`` from apx's leaves
    (``state.inner.perception.*`` as for ``image_state_from_numpy``,
    ``state.inner.target`` (N, 2), ``state.inner.target_glimpse``
    (N, s0, s1, C) and ``state.prev_done``)."""
    inner = ImageLocalizationState(
        perception=_perception_state(image, label, data_index, pos, time, label_inverted,
                                     device),
        target=_t(np.asarray(target, dtype=np.float32), torch.float32, device),
        target_glimpse=_t(np.asarray(target_glimpse, dtype=np.float32), torch.float32, device),
    )
    return VectorState(inner=inner,
                       prev_done=_t(np.asarray(prev_done, dtype=np.bool_), torch.bool, device))


def light_dark_state_from_numpy(pos, t, prev_done, device="cuda") -> VectorState:
    """Vector state of ``TimeLimit(LightDarkEnv)`` from apx's leaves
    (``state.inner.inner.pos``, ``state.inner.t``, ``state.prev_done``)."""
    inner = LightDarkState(pos=_t(np.asarray(pos, dtype=np.float32), torch.float32, device))
    return VectorState(
        inner=TimeLimitState(inner=inner, t=_t(np.asarray(t).astype(np.int32), torch.int32, device)),
        prev_done=_t(np.asarray(prev_done, dtype=np.bool_), torch.bool, device),
    )


def metrics_state_from_numpy(inner: VectorState, buf, count, prev_done,
                             device="cuda") -> MetricsState:
    """State of a metrics-wrapped vector env: ``inner`` is the converted
    vector state (``state.inner`` of apx's), ``buf`` apx's dict of (N, L)
    ring buffers, ``count`` and ``prev_done`` its (N,) leaves."""
    return MetricsState(
        inner=inner,
        buf={k: _t(np.asarray(v, dtype=np.float32), torch.float32, device) for k, v in buf.items()},
        count=_t(np.asarray(count).astype(np.int32), torch.int32, device),
        prev_done=_t(np.asarray(prev_done, dtype=np.bool_), torch.bool, device),
    )


def _net_state(net: dict, device) -> dict[str, torch.Tensor]:
    """The port's state dict of apx's nested weight dict: dense ``w`` (in,
    out) transposed to (out, in), HWIO kernels to OIHW, the LSTM cell's
    leaves unchanged."""
    state = {}
    for name, leaves in net.items():
        for k, v in leaves.items():
            v = np.asarray(v, dtype=np.float32)
            if name == "lstm":
                state[f"{name}.{k}"] = _t(v, torch.float32, device)
            elif k == "w":
                state[f"{name}.weight"] = _t(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T,
                                             torch.float32, device)
            else:
                state[f"{name}.bias"] = _t(v, torch.float32, device)
    return state


def _map_hw(net: dict) -> tuple[int, int]:
    """The (square) map size behind ``map_proj``'s (h/4 * w/4 * 32) rows."""
    side = 4 * math.isqrt(np.asarray(net["map_proj"]["w"]).shape[0] // 32)
    return side, side


def ppo_net_from_numpy(net: dict, device="cuda"):
    """``PPONet`` from apx's ``init_net`` dict (``examples/train_ppo_lidar``)."""
    from .examples.train_ppo_lidar import PPONet

    out = PPONet(_map_hw(net), device)
    out.load_state_dict(_net_state(net, device))
    return out


def r2d2_net_from_numpy(net: dict, device="cuda"):
    """``R2D2Net`` from apx's ``init_r2d2_net`` dict
    (``examples/train_r2d2_mesh``); the hidden size is ``wh``'s."""
    from .examples.train_r2d2_mesh import R2D2Net

    out = R2D2Net(_map_hw(net), np.asarray(net["lstm"]["wh"]).shape[0], device)
    out.load_state_dict(_net_state(net, device))
    return out
