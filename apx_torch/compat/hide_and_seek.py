"""Host-side hide-and-seek wrapper for the compat layer (counterpart of
apx.compat.hide_and_seek).

Numpy mirror of the reference CircleSquareHideAndSeekVectorWrapper
(circle_square_catch_or_flee.py:19-107) over GymVectorAPEnv (gymnasium is
imported only for the masked variant's empty spaces) — the
additional reward is computed after the autoreset layer exactly like the
reference, including the masked-prediction variant's zero-logit injection
and its info quirks.
"""

from __future__ import annotations

import numpy as np

from ..ops.glimpse import sensor_pos_lim_pixels

__all__ = ["GymHideAndSeekWrapper"]


class GymHideAndSeekWrapper:
    def __init__(self, env, mask_prediction: bool = False):
        self.env = env
        self.mask_prediction = mask_prediction
        params = env.params
        h, w, _ = params.dataset.image_shape
        self._image_wh = (w, h)
        self._lim = np.asarray(
            sensor_pos_lim_pixels((h, w), params.sensor_size, params.sensor_scale)
        )
        if mask_prediction:
            import gymnasium as gym

            self.single_prediction_space = gym.spaces.Tuple(())
            self.single_prediction_target_space = gym.spaces.Tuple(())
            self.single_action_space = gym.spaces.Dict(
                {
                    "action": env.single_action_space["action"],
                    "prediction": gym.spaces.Tuple(()),
                }
            )
            self.action_space = gym.vector.utils.batch_space(
                self.single_action_space, env.num_envs
            )

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        if self.mask_prediction and "prediction" in info:
            info = {**info, "prediction": {**info["prediction"], "target": ()}}
        return obs, info

    def step(self, actions):
        if self.mask_prediction:
            k = self.env.single_prediction_space.shape[-1]
            actions = {
                "action": actions["action"],
                "prediction": np.zeros((self.env.num_envs, k), np.float32),
            }
        obs, reward, terminated, truncated, info = self.env.step(actions)

        idx = np.asarray(info["index"])
        label = idx % 2
        rem = idx // 2
        w, _ = self._image_wh
        px = (rem % w).astype(np.float64)
        py = (rem // w).astype(np.float64)
        pos_norm = np.stack([px, py], axis=-1) / self._lim - 1.0
        dist = np.linalg.norm(np.asarray(obs["glimpse_pos"]) - pos_norm, axis=-1)
        additional = (label * 2 - 1) * dist

        info = dict(info)
        info["base_reward"] = info["base_reward"] + additional
        if self.mask_prediction:
            t = info["prediction"]["target"]
            empty = {**t, "target": ()} if isinstance(t, dict) else ()
            info["prediction"] = {**info["prediction"], "target": empty}
            reward = info["base_reward"]
        else:
            reward = reward + additional
        return obs, reward, terminated, truncated, info
