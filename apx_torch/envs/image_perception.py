"""Shared glimpse-on-image engine of the image envs, batched over envs
(counterpart of apx.envs.image_perception).

Same semantics as apx's engine (after ap_gym's image_perception_module):
  * the action is projected into the unit disc, scaled by
    ``max_step_length``, added to the normalized position and clipped to
    [-1, 1]^2;
  * base_reward = -1e-3 |action| of the raw action;
  * an episode terminates when its time reaches ``step_limit``;
  * obs = {glimpse, glimpse_pos, time_step[, inverted_label]} with
    time_step = 2 t / step_limit - 1; inverted_label is 0/1 at t = 0 and 2
    afterwards;
  * a reset draws one dataset index, the label inversion and a start
    position uniform in [-1, 1)^2.

Every glimpse, of a step and of a reset, goes through K3
(``apx_torch.ops.glimpse_cuda``). The state carries the episode's image as
an (N, H, W, C) tensor in the bank's dtype (apx's ``image_storage="array"``,
its default); apx's other storage modes and its unique-target sampler (the
image localization envs' reset) are not ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from ..core.numerics import fma, time_obs
from ..core.spaces import Box, DictSpace, Discrete, Image
from ..data.dataset import ImageDataset
from ..ops.geometry import norm2, project_sphere
from ..ops.glimpse_cuda import glimpse

__all__ = ["ImagePerceptionParams", "ImagePerceptionState", "ImagePerceptionEngine"]


@dataclasses.dataclass(frozen=True, eq=False)
class ImagePerceptionParams:
    """The fields of apx's ImagePerceptionParams that the classification
    path reads."""

    dataset: ImageDataset
    sensor_size: tuple[int, int] = (5, 5)
    sensor_scale: float = 1.0
    max_step_length: tuple[float, float] = (0.2, 0.2)
    step_limit: int = 16
    randomly_invert_labels: bool = False
    # apx's A/B switches: "auto" resolves to what apx resolves it to.
    glimpse_window: str = "auto"
    image_storage: str = "auto"

    def __post_init__(self):
        if self.glimpse_window not in ("auto", "off"):
            raise NotImplementedError(
                f"glimpse_window={self.glimpse_window!r} is not ported; apx pins 'rows' "
                "bitwise-equal to 'off' and keeps it as an A/B surface (ROADMAP.md, queue 1)"
            )
        if self.image_storage not in ("auto", "array"):
            raise NotImplementedError(
                f"image_storage={self.image_storage!r} is not ported; the state carries "
                "the image as an array, apx's default (ROADMAP.md, queue 1)"
            )

    @property
    def device(self) -> torch.device:
        return self.dataset.device

    @functools.cached_property
    def max_step(self) -> torch.Tensor:
        """(2,) float32 max step per axis."""
        return torch.tensor(self.max_step_length, dtype=torch.float32, device=self.device)


@dataclasses.dataclass
class ImagePerceptionState:
    image: torch.Tensor  # (N, H, W, C) uint8 or float32, the episode's image
    label: torch.Tensor  # (N,) int64
    data_index: torch.Tensor  # (N,) int64
    pos: torch.Tensor  # (N, 2) float32 normalized (x, y)
    time: torch.Tensor  # (N,) int32
    label_inverted: torch.Tensor  # (N,) bool


class ImagePerceptionEngine:
    """Stateless helper implementing the shared mechanics."""

    @staticmethod
    def observation_space_dict(params: ImagePerceptionParams) -> dict[str, Any]:
        s0, s1 = params.sensor_size
        _, _, c = params.dataset.image_shape
        d: dict[str, Any] = {
            "glimpse": Image.create(width=s1, height=s0, channels=c),
            "glimpse_pos": Box(low=-1.0, high=1.0, shape=(2,)),
            "time_step": Box(low=-1.0, high=1.0, shape=()),
        }
        if params.randomly_invert_labels:
            d["inverted_label"] = Discrete(3)
        return d

    @staticmethod
    def observation_space(params: ImagePerceptionParams) -> DictSpace:
        return DictSpace(ImagePerceptionEngine.observation_space_dict(params))

    @staticmethod
    def inner_action_space(params: ImagePerceptionParams) -> Box:
        return Box(low=-1.0, high=1.0, shape=(2,))

    @staticmethod
    def draw_reset(num_envs: int, params: ImagePerceptionParams,
                   generator: torch.Generator) -> dict[str, torch.Tensor]:
        """index ~ U[0, D), inverted ~ Bernoulli(1/2) when labels are
        randomly inverted (else False), pos ~ U[-1, 1)^2."""
        dev = params.device
        index = torch.randint(0, params.dataset.length, (num_envs,), generator=generator,
                              device=dev)
        if params.randomly_invert_labels:
            inverted = torch.randint(0, 2, (num_envs,), generator=generator, device=dev) == 1
        else:
            inverted = torch.zeros(num_envs, dtype=torch.bool, device=dev)
        pos = torch.rand((num_envs, 2), generator=generator, device=dev) * 2.0 - 1.0
        return {"index": index, "inverted": inverted, "pos": pos}

    @staticmethod
    def reset_from_draws(draws: dict[str, torch.Tensor],
                         params: ImagePerceptionParams) -> ImagePerceptionState:
        dev = params.device
        idx = torch.as_tensor(draws["index"], device=dev).to(torch.int64)
        image, label = params.dataset.fetch_raw(idx)
        inverted = torch.as_tensor(draws["inverted"], device=dev).to(torch.bool)
        if params.randomly_invert_labels:
            label = torch.where(inverted, params.dataset.num_classes - label - 1, label)
        else:
            inverted = torch.zeros_like(inverted)
        pos = torch.as_tensor(draws["pos"], device=dev).to(torch.float32)
        return ImagePerceptionState(
            image=image,
            label=label,
            data_index=idx,
            pos=pos,
            time=torch.zeros(idx.shape[0], dtype=torch.int32, device=dev),
            label_inverted=inverted,
        )

    @staticmethod
    def move(state: ImagePerceptionState, action: torch.Tensor, params: ImagePerceptionParams):
        """Returns (new_state, base_reward, terminated). The jitted reference
        contracts ``pos + max_step * proj`` into one FMA."""
        pos = fma(params.max_step, project_sphere(action), state.pos).clamp(-1.0, 1.0)
        base_reward = -norm2(action) * 1e-3
        time = state.time + 1
        terminated = time >= params.step_limit
        return dataclasses.replace(state, pos=pos, time=time), base_reward, terminated

    @staticmethod
    def get_glimpse(state: ImagePerceptionState, pos: torch.Tensor,
                    params: ImagePerceptionParams) -> torch.Tensor:
        return glimpse(state.image, pos, params.sensor_size, params.sensor_scale)

    @staticmethod
    def observe(state: ImagePerceptionState, params: ImagePerceptionParams) -> dict[str, torch.Tensor]:
        obs = {
            "glimpse": ImagePerceptionEngine.get_glimpse(state, state.pos, params),
            "glimpse_pos": state.pos,
            "time_step": time_obs(state.time, params.step_limit),
        }
        if params.randomly_invert_labels:
            obs["inverted_label"] = torch.where(
                state.time > 0, 2, state.label_inverted.to(torch.int32)
            ).to(torch.int32)
        return obs

    @staticmethod
    def info(state: ImagePerceptionState) -> dict[str, torch.Tensor]:
        return {"index": state.data_index}

    @staticmethod
    def sample_unique_glimpse_position(*args, **kwargs):
        """apx's unique-target sampler (the image localization reset)."""
        raise NotImplementedError(
            "the unique-target sampler is not ported yet (ROADMAP.md, queue 1)"
        )
