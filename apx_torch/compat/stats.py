"""Episode-metric bookkeeping of the compat log wrappers, without
gymnasium (counterpart of the aggregation in apx.compat.log).

Output-compatible with the reference wrappers' stats:
  * ActiveClassificationLogWrapper / ...VectorLogWrapper
    (active_classification_env.py:68-197): per-step correct_label_prob,
    episode-end accuracy/first_correct/last_incorrect,
  * ActiveRegressionLogWrapper / ...VectorLogWrapper
    (active_regression_env.py:113-227): per-step euclidean_distance/mse,
  * aggregation contract of util.py:18-83 (info["stats"]["scalar"/"vector"]
    with avg_*/final_* and Gymnasium ``_key`` validity masks).

``log.py`` wraps these in gymnasium classes; ``chip_smoke.py`` runs the
vector forms over the adapter core on the card.
"""

from __future__ import annotations

import numpy as np
import scipy.special

__all__ = ["merge_stats", "merge_stats_vec", "VectorRegressionStats",
           "VectorClassificationStats"]


def merge_stats(info, metrics):
    """Single-env merge (util.py:18-37)."""
    scalar = {}
    vector = {}
    for name, series in metrics.items():
        scalar[f"avg_{name}"] = float(np.mean(series))
        scalar[f"final_{name}"] = float(series[-1])
        vector[name] = list(series)
    stats = dict(info.get("stats", {}))
    stats.setdefault("scalar", {}).update(scalar)
    stats.setdefault("vector", {}).update(vector)
    return {**info, "stats": stats}


def merge_stats_vec(info, metrics, done):
    """Vector merge with _key validity masks (util.py:40-83)."""
    scalar, vector = {}, {}
    for name, series in metrics.items():
        scalar[f"final_{name}"] = np.array(
            [e[-1] if t and len(e) else np.nan for t, e in zip(done, series)],
            dtype=np.float32,
        )
        scalar[f"_final_{name}"] = done
        scalar[f"avg_{name}"] = np.array(
            [np.mean(e) if t and len(e) else np.nan for t, e in zip(done, series)],
            dtype=np.float32,
        )
        scalar[f"_avg_{name}"] = done
        arr = np.array(
            [(list(e) if t else []) for e, t in zip(series, done)] + [None],
            dtype=object,
        )[:-1]
        vector[name] = arr
        vector[f"_{name}"] = done
    stats = dict(info.get("stats", {}))
    stats.setdefault("scalar", {}).update(scalar)
    stats["_scalar"] = done
    stats.setdefault("vector", {}).update(vector)
    stats["_vector"] = done
    return {**info, "stats": stats}


def _step_target(info):
    target = info["prediction"]["target"]
    if isinstance(target, dict):
        target = target["target"]
    return target


class _VectorStats:
    """Per-env metric series over a vector env's steps; ``update`` adds the
    episode stats to the info of every step where an env ends."""

    _names: tuple[str, ...] = ()

    def __init__(self, num_envs: int):
        self.num_envs = num_envs
        self._series = {m: [[] for _ in range(num_envs)] for m in self._names}
        self._prev_done = np.zeros(num_envs, dtype=bool)

    def _values(self, action, info):
        raise NotImplementedError

    def update(self, action, terminated, truncated, info):
        # On an all-reset step no sub-env produced step info (gymnasium
        # emits only the reset infos — no "prediction" key), and every
        # series is cleared below, so there is nothing to evaluate.
        vals = None if self._prev_done.all() else self._values(action, info)
        for i in range(self.num_envs):
            for m in self._names:
                if self._prev_done[i]:
                    self._series[m][i].clear()
                else:
                    self._series[m][i].append(vals[m][i])
        self._prev_done = np.asarray(terminated) | np.asarray(truncated)
        if self._prev_done.any():
            info = self._emit(info, self._prev_done)
        return info

    def _emit(self, info, done):
        return merge_stats_vec(info, self._series, done)


class VectorRegressionStats(_VectorStats):
    _names = ("euclidean_distance", "mse")

    def _values(self, action, info):
        pred = np.asarray(action["prediction"])
        t = np.asarray(_step_target(info))
        return {
            "euclidean_distance": np.linalg.norm(t - pred, axis=-1),
            "mse": np.mean((t - pred) ** 2, axis=-1),
        }


class VectorClassificationStats(_VectorStats):
    _names = ("correct_label_prob",)

    def __init__(self, num_envs: int, num_classes: int):
        super().__init__(num_envs)
        self.num_classes = num_classes

    def _values(self, action, info):
        p = scipy.special.softmax(np.asarray(action["prediction"]), axis=-1)
        idx = np.asarray(_step_target(info)).astype(int)
        return {
            "correct_label_prob": np.take_along_axis(p, idx[:, None], axis=-1)[:, 0]
        }

    def _emit(self, info, done):
        n, k = self.num_envs, self.num_classes
        probs = [
            np.array(e, dtype=np.float32)
            for e in self._series["correct_label_prob"]
        ]
        is_correct = [e > 1 / k for e in probs]
        series = {
            **self._series,
            "accuracy": [c.astype(np.float32) for c in is_correct],
        }
        info = merge_stats_vec(info, series, done)
        first_correct = np.full(n, -1, dtype=np.int32)
        first_valid = np.zeros(n, dtype=bool)
        last_incorrect = np.full(n, -1, dtype=np.int32)
        last_valid = np.zeros(n, dtype=bool)
        for i in range(n):
            wc = np.where(is_correct[i])[0]
            if len(wc):
                first_correct[i], first_valid[i] = wc[0], True
            wi = np.where(~is_correct[i])[0]
            if len(wi):
                last_incorrect[i], last_valid[i] = wi[-1], True
        info["stats"]["scalar"].update(
            {
                "first_correct": first_correct,
                "_first_correct": first_valid,
                "last_incorrect": last_incorrect,
                "_last_incorrect": last_valid,
            }
        )
        return info
