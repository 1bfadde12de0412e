"""Wire codecs: lossless device-side re-encodings of observation leaves
for the adapter's device-to-host copy (counterpart of apx.compat.wire).

The adapter returns numpy observations every step, so the obs payload
crosses to the host every step. The LIDAR dynamic-map channel is f32
valued in {0, 1/255} (the reference divides the boolean occupancy by 255,
lidar_localization2d.py:299): 32 bits on the wire per bit of information,
16 MB per step at N=4096. The codec packs it to bits on the device, 512 KB
per step, and rebuilds the exact f32 array on the host with apx's op
sequence (bit -> f32 -> / 255), so the decoded map is bitwise the device's.

torch has no shifts on uint32, so the device side packs with uint8
weights 1, 2, ..., 128 and a sum, which gives the bytes apx's
``left_shift`` weights give. Codecs change only the transfer
representation; every value a user sees is unchanged.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..envs.lidar_localization import LIDARLocalizationEnv

__all__ = ["wire_codec_for"]

EncodeFn = Callable[[dict[str, Any]], dict[str, Any]]
DecodeFn = Callable[[dict[str, Any]], dict[str, Any]]


def wire_codec_for(base_env, params) -> tuple[EncodeFn, DecodeFn] | None:
    """(device_encode, host_decode) for this env's obs dict, or None.

    device_encode takes the batched obs dict of tensors and returns it with
    the encoded leaves; host_decode takes the copied numpy dict and inverts
    it bitwise."""
    if isinstance(base_env, LIDARLocalizationEnv) and not params.static_map:
        h, w, _ = base_env.observation_space(params)["map"].shape
        return _lidar_map_codec(h, w)
    return None


def _lidar_map_codec(h: int, w: int) -> tuple[EncodeFn, DecodeFn]:
    w_pad = (-w) % 8
    wb = (w + w_pad) // 8
    weights: dict[torch.device, torch.Tensor] = {}

    def encode(obs: dict[str, Any]) -> dict[str, Any]:
        m = obs["map"]  # (N, h, w, 1) f32 in {0, 1/255}
        bits = m[..., 0] != 0
        if w_pad:
            bits = torch.nn.functional.pad(bits, (0, w_pad))
        groups = bits.reshape(bits.shape[0], h, wb, 8).to(torch.uint8)
        if m.device not in weights:
            weights[m.device] = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                                             device=m.device)
        packed = (groups * weights[m.device]).sum(dim=-1, dtype=torch.uint8)
        return {**obs, "map": packed}  # (N, h, wb) u8

    def decode(obs: dict[str, Any]) -> dict[str, Any]:
        p = np.asarray(obs["map"])  # (N, h, wb) u8
        bits = (p[..., None] >> np.arange(8, dtype=np.uint8)) & np.uint8(1)
        occ = bits.reshape(p.shape[0], h, wb * 8)[:, :, :w]
        # Same op sequence as the device obs (bool -> f32 -> /255), so the
        # nonzero value rounds to the identical f32 (1/255).
        m = occ.astype(np.float32) / np.float32(255.0)
        return {**obs, "map": m[..., None]}

    return encode, decode
