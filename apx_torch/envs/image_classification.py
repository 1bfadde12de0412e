"""Glimpse-based image classification env, batched over envs (counterpart
of apx.envs.image_classification): logit predictions over the dataset's
classes, the episode's label as the target, and the normalized
cross-entropy loss. It runs under LOCKSTEP autoreset (its registry ids
say so), where the reset step's loss target is the new episode's label.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.env import APEnv, APStepResult
from ..core.losses import CrossEntropyLossFn, LossFn
from ..core.spaces import Discrete, Logit, Space
from ..data.dataset import ImageDataset
from .image_perception import ImagePerceptionEngine, ImagePerceptionParams, ImagePerceptionState

__all__ = ["ImageClassificationEnv"]


class ImageClassificationEnv(APEnv[ImagePerceptionParams, ImagePerceptionState]):
    def __init__(self, dataset: ImageDataset | None = None, **config):
        self._dataset = dataset
        self._config = config

    def default_params(self, **overrides) -> ImagePerceptionParams:
        cfg = {**self._config, **overrides}
        dataset = cfg.pop("dataset", self._dataset)
        if dataset is None:
            raise ValueError("ImageClassificationEnv requires a dataset")
        if "max_step_length" in cfg and not isinstance(cfg["max_step_length"], (tuple, list)):
            cfg["max_step_length"] = (cfg["max_step_length"], cfg["max_step_length"])
        return ImagePerceptionParams(dataset=dataset, **cfg)

    # ---- spaces / loss ------------------------------------------------------
    def observation_space(self, params) -> Space:
        return ImagePerceptionEngine.observation_space(params)

    def inner_action_space(self, params) -> Space:
        return ImagePerceptionEngine.inner_action_space(params)

    def prediction_space(self, params) -> Space:
        return Logit(low=-np.inf, high=np.inf, shape=(params.dataset.num_classes,))

    def prediction_target_space(self, params) -> Space:
        return Discrete(params.dataset.num_classes)

    def loss_fn(self, params) -> LossFn:
        return CrossEntropyLossFn(num_classes=params.dataset.num_classes).normalized

    # ---- dynamics -----------------------------------------------------------
    def draw_reset(self, num_envs, params, generator) -> dict[str, torch.Tensor]:
        return ImagePerceptionEngine.draw_reset(num_envs, params, generator)

    def reset_from_draws(self, draws, params):
        state = ImagePerceptionEngine.reset_from_draws(draws, params)
        return (ImagePerceptionEngine.observe(state, params), state,
                ImagePerceptionEngine.info(state))

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        new_state, base_reward, terminated = ImagePerceptionEngine.move(state, action, params)
        return APStepResult(
            obs=ImagePerceptionEngine.observe(new_state, params),
            state=new_state,
            base_reward=base_reward,
            terminated=terminated,
            truncated=torch.zeros_like(terminated),
            info=ImagePerceptionEngine.info(new_state),
            prediction_target=new_state.label,
        )

    def prediction_target_on_reset(self, old_state, new_state, params):
        """On the LOCKSTEP reset step the target is the new episode's label."""
        return new_state.label
