"""Glimpse-based image localization env, batched over envs (counterpart of
apx.envs.image_localization, after ap_gym's image_localization).

* The task is regression: predict the normalized (x, y) of a target whose
  glimpse the agent is shown; the loss is the normalized MSE,
  3 * mean((target - prediction)^2).
* An explicit reset takes the target from the unique-target sampler
  (``ImagePerceptionEngine.unique_target_from_draws``); an autoreset draws
  it uniformly in [-1, 1)^2 and never runs the sampler's sweep, so the
  vector step, which runs the autoreset for all N every step, stays cheap.
* The obs adds ``target_glimpse``. The target is constant within an
  episode, so its glimpse is taken once per (auto)reset, through K3, and
  carried in the state.
* The loss on a LOCKSTEP reset step is against the previous episode's
  target.

Draws: ``draw_reset`` gives the perception draws (index, inverted, pos),
the sampler's (``sel``, ``jitter``) and the autoreset's uniform
``target``, so one draw serves either reset.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.env import APEnv, APStepResult
from ..core.losses import LossFn
from ..core.spaces import DictSpace, Image, Space
from ..data.dataset import ImageDataset
from .common import make_regression_loss_and_target_space
from .image_perception import ImagePerceptionEngine, ImagePerceptionParams, ImagePerceptionState

__all__ = ["ImageLocalizationEnv", "ImageLocalizationState"]


@dataclasses.dataclass
class ImageLocalizationState:
    perception: ImagePerceptionState
    target: torch.Tensor  # (N, 2) float32 normalized target position
    target_glimpse: torch.Tensor  # (N, s0, s1, C) float32


def _loss_and_space():
    # As apx's jitted step rounds them: the sum of squares is not
    # contracted (XLA vectorises the two-element reduce), and the reward is
    # fma(-sum, 1.5, base_reward) (``AffineLossFn.reward``).
    return make_regression_loss_and_target_space(2, -1.0, 1.0, fused_sum=False,
                                                 contract_reward=True)


class ImageLocalizationEnv(APEnv[ImagePerceptionParams, ImageLocalizationState]):
    def __init__(self, dataset: ImageDataset | None = None, **config):
        self._dataset = dataset
        self._config = config

    def default_params(self, **overrides) -> ImagePerceptionParams:
        cfg = {**self._config, **overrides}
        dataset = cfg.pop("dataset", self._dataset)
        if dataset is None:
            raise ValueError("ImageLocalizationEnv requires a dataset")
        if "max_step_length" in cfg and not isinstance(cfg["max_step_length"], (tuple, list)):
            cfg["max_step_length"] = (cfg["max_step_length"], cfg["max_step_length"])
        return ImagePerceptionParams(dataset=dataset, **cfg)

    # ---- spaces / loss ------------------------------------------------------
    def observation_space(self, params) -> Space:
        s0, s1 = params.sensor_size
        _, _, c = params.dataset.image_shape
        d = ImagePerceptionEngine.observation_space_dict(params)
        d["target_glimpse"] = Image.create(width=s1, height=s0, channels=c)
        return DictSpace(d)

    def inner_action_space(self, params) -> Space:
        return ImagePerceptionEngine.inner_action_space(params)

    def prediction_space(self, params) -> Space:
        return _loss_and_space()[1]

    def prediction_target_space(self, params) -> Space:
        return _loss_and_space()[1]

    def loss_fn(self, params) -> LossFn:
        return _loss_and_space()[0]

    # ---- dynamics -----------------------------------------------------------
    @staticmethod
    def make_state(perception: ImagePerceptionState, target: torch.Tensor,
                   params) -> ImageLocalizationState:
        """The state of a reset to ``target`` (N, 2), its glimpse taken."""
        target = target.to(torch.float32)
        return ImageLocalizationState(
            perception=perception, target=target,
            target_glimpse=ImagePerceptionEngine.get_glimpse(perception, target, params),
        )

    @staticmethod
    def observe(state: ImageLocalizationState, params) -> dict[str, torch.Tensor]:
        obs = ImagePerceptionEngine.observe(state.perception, params)
        obs["target_glimpse"] = state.target_glimpse
        return obs

    def _reset(self, perception, target, params):
        state = self.make_state(perception, target, params)
        return self.observe(state, params), state, ImagePerceptionEngine.info(perception)

    def draw_reset(self, num_envs, params, generator) -> dict[str, torch.Tensor]:
        """The perception draws, then the sampler's ``sel`` and ``jitter``,
        then the autoreset's ``target`` uniform in [-1, 1)^2."""
        draws = ImagePerceptionEngine.draw_reset(num_envs, params, generator)
        draws.update(ImagePerceptionEngine.draw_unique_target(num_envs, params, generator))
        u = torch.rand((num_envs, 2), generator=generator, device=params.device)
        draws["target"] = u * 2.0 - 1.0
        return draws

    def reset_from_draws(self, draws, params):
        """Explicit reset: the target from the unique-target sampler."""
        perception = ImagePerceptionEngine.reset_from_draws(draws, params)
        dev = params.device
        target = ImagePerceptionEngine.unique_target_from_draws(
            ImagePerceptionEngine.image_raw(perception, params),
            torch.as_tensor(draws["sel"], device=dev),
            torch.as_tensor(draws["jitter"], device=dev).to(torch.float32), params)
        return self._reset(perception, target, params)

    def autoreset_from_draws(self, draws, old_state, params, only=None):
        """Mid-run reset: the uniform target, no sweep; every env (``only``
        is not used)."""
        perception = ImagePerceptionEngine.reset_from_draws(draws, params)
        target = torch.as_tensor(draws["target"], device=params.device)
        return self._reset(perception, target, params)

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        perception, obs, base_reward, terminated, truncated = ImagePerceptionEngine.step(
            state.perception, action, params)
        obs["target_glimpse"] = state.target_glimpse
        return APStepResult(
            obs=obs,
            state=dataclasses.replace(state, perception=perception),
            base_reward=base_reward,
            terminated=terminated,
            truncated=truncated,
            info=ImagePerceptionEngine.info(perception),
            prediction_target=state.target,
        )

    def prediction_target_on_reset(self, old_state, new_state, params):
        """The loss on the LOCKSTEP reset step is against the previous
        episode's target."""
        return old_state.target
