"""Host-side episode-metric log wrappers for the compat layer
(counterpart of apx.compat.log): gymnasium classes over the aggregation
in ``stats.py``, output-compatible with the reference's log wrappers.
This module imports gymnasium.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
import scipy.special

from .stats import VectorClassificationStats, VectorRegressionStats, merge_stats

__all__ = [
    "ClassificationLogWrapper",
    "RegressionLogWrapper",
    "VectorClassificationLogWrapper",
    "VectorRegressionLogWrapper",
]


class _Delegate(gym.Env):
    """Delegating wrapper base. A real gym.Env subclass so foreign gym
    wrappers accept log-wrapped compat envs; attributes gym.Env defines on
    the class (metadata/render_mode/spec) are delegated explicitly since
    __getattr__ only fires for missing names."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    @property
    def metadata(self):
        return self.env.metadata

    @metadata.setter
    def metadata(self, value):
        self.env.metadata = value

    @property
    def render_mode(self):
        return getattr(self.env, "render_mode", None)

    @property
    def spec(self):
        return getattr(self.env, "spec", None)

    @property
    def unwrapped(self):
        return self.env.unwrapped if hasattr(self.env, "unwrapped") else self.env

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()


class ClassificationLogWrapper(_Delegate):
    def reset(self, **kwargs):
        self._probs: list[float] = []
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        target = info["prediction"]["target"]
        if isinstance(target, dict):
            target = target["target"]
        self._probs.append(
            float(scipy.special.softmax(np.asarray(action["prediction"]))[int(target)])
        )
        if terminated or truncated:
            k = self.env.prediction_space.shape[-1]
            probs = np.array(self._probs, dtype=np.float32)
            is_correct = probs > 1 / k
            metrics = {
                "correct_label_prob": probs,
                "accuracy": is_correct.astype(np.float32),
            }
            info = merge_stats(info, metrics)
            where_c = np.where(is_correct)[0]
            if len(where_c):
                info["stats"]["scalar"]["first_correct"] = where_c[0]
            where_i = np.where(~is_correct)[0]
            if len(where_i):
                info["stats"]["scalar"]["last_incorrect"] = where_i[-1]
        return obs, reward, terminated, truncated, info


class RegressionLogWrapper(_Delegate):
    def reset(self, **kwargs):
        self._dist: list[float] = []
        self._mse: list[float] = []
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        target = info["prediction"]["target"]
        if isinstance(target, dict):
            target = target["target"]
        pred = np.asarray(action["prediction"])
        t = np.asarray(target)
        self._dist.append(float(np.linalg.norm(t - pred)))
        self._mse.append(float(np.mean((t - pred) ** 2)))
        if terminated or truncated:
            info = merge_stats(
                info, {"euclidean_distance": self._dist, "mse": self._mse}
            )
        return obs, reward, terminated, truncated, info


class _VectorLogBase(_Delegate):
    def _make_stats(self):
        raise NotImplementedError

    def reset(self, **kwargs):
        self._stats = self._make_stats()
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        info = self._stats.update(action, terminated, truncated, info)
        return obs, reward, terminated, truncated, info


class VectorRegressionLogWrapper(_VectorLogBase):
    def _make_stats(self):
        return VectorRegressionStats(self.env.num_envs)


class VectorClassificationLogWrapper(_VectorLogBase):
    def _make_stats(self):
        return VectorClassificationStats(
            self.env.num_envs, self.env.single_prediction_space.shape[-1])
