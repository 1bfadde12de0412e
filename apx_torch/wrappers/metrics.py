"""Episode-metric wrappers over a vector env (counterpart of
apx.wrappers.metrics).

* ``ClassificationMetrics``: per step ``correct_label_prob`` =
  softmax(prediction)[target]; on done ``avg_``/``final_`` of it and of
  ``accuracy`` (prob > 1/K), and the ``first_correct`` / ``last_incorrect``
  step indices with their validity flags.
* ``RegressionMetrics``: per step ``euclidean_distance`` and ``mse`` of
  the prediction against the loss target.

Each env keeps its episode's per-step values in an (N, L) ring buffer with
a step count. Every aggregate is a masked reduction computed each step
and gated by the done mask, so the wrapper never asks the host anything.
``info["stats"]`` carries ``scalar`` (``avg_*``/``final_*``, NaN where
not done, with ``_key`` masks equal to done), ``vector`` (the raw buffers)
and ``vector_lengths``. The step that completes an episode is recorded;
the autoreset step after it clears the buffer and records nothing. The
buffer update is apx's arithmetic ``buf * (1 - onehot) + onehot * v``,
so a non-finite value spreads as it does there. The bookkeeping after the
inner step (the step's metrics, the buffers, the aggregates) runs inside
the span ``vector.metrics``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.trace import span
from ..ops.geometry import norm2

__all__ = ["ClassificationMetrics", "RegressionMetrics", "MetricsState"]


@dataclasses.dataclass
class MetricsState:
    inner: Any
    buf: dict[str, torch.Tensor]  # name -> (N, L) f32
    count: torch.Tensor  # (N,) int32, valid entries per env
    prev_done: torch.Tensor  # (N,) bool


def _pick(buf_m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf_m[n, idx[n]] as a one-hot select-reduce (apx's gather-free pick)."""
    onehot = torch.arange(buf_m.shape[-1], device=buf_m.device) == idx[:, None]
    return torch.where(onehot, buf_m, 0.0).sum(dim=-1)


def _target(info) -> torch.Tensor:
    target = info["prediction"]["target"]
    return target["target"] if isinstance(target, dict) else target  # sparse ids


@dataclasses.dataclass(frozen=True)
class _MetricsWrapper:
    """Shared machinery; subclasses define the per-step metrics."""

    venv: Any
    buffer_len: int

    @property
    def num_envs(self) -> int:
        return self.venv.num_envs

    @property
    def env(self):
        return self.venv.env

    @property
    def autoreset(self):
        """Delegated, so ``with_autoreset`` recurses into ``venv`` and the
        episodic LOCKSTEP rollout runs metrics-wrapped envs."""
        return self.venv.autoreset

    def _metric_names(self) -> tuple[str, ...]:
        raise NotImplementedError

    def _step_metrics(self, full_action, info, params) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def _extra_stats(self, buf, valid, count, done, params) -> dict[str, torch.Tensor]:
        return {}

    def reset(self, params, generator: torch.Generator | None = None, draws=None):
        obs, inner, info = self.venv.reset(params, generator, draws=draws)
        n, length, dev = self.num_envs, self.buffer_len, inner.prev_done.device
        state = MetricsState(
            inner=inner,
            buf={m: torch.zeros((n, length), dtype=torch.float32, device=dev)
                 for m in self._metric_names()},
            count=torch.zeros(n, dtype=torch.int32, device=dev),
            prev_done=torch.zeros(n, dtype=torch.bool, device=dev),
        )
        return obs, state, info

    def step(self, state: MetricsState, full_action, params, generator=None, reset_draws=None,
             step_draws=None):
        out = self.venv.step(state.inner, full_action, params, generator,
                             reset_draws=reset_draws, step_draws=step_draws)
        return self._book(state, out, full_action, params)

    def boundary_reset_step(self, state: MetricsState, full_action, params, generator=None,
                            reset_draws=None, step_draws=None):
        """The LOCKSTEP boundary step: prev_done is all True there, so the
        bookkeeping clears the buffers without recording, as ``step``'s
        autoreset does."""
        out = self.venv.boundary_reset_step(state.inner, full_action, params, generator,
                                            reset_draws=reset_draws, step_draws=step_draws)
        return self._book(state, out, full_action, params)

    @span("vector.metrics")
    def _book(self, state: MetricsState, out, full_action, params):
        obs, inner2, reward, term, trunc, info = out
        length = self.buffer_len
        vals = self._step_metrics(full_action, info, params)
        steps = torch.arange(length, dtype=torch.int32, device=state.count.device)

        # Clear on the autoreset step (no record); otherwise append at count.
        count0 = torch.where(state.prev_done, 0, state.count)
        record = state.prev_done.logical_not()
        slot = count0.clamp(0, length - 1)
        onehot = (steps == slot[:, None]).to(torch.float32) * record[:, None]
        buf = {m: state.buf[m] * (1.0 - onehot) + onehot * vals[m][:, None]
               for m in self._metric_names()}
        count = count0 + record.to(torch.int32)

        done = term | trunc
        valid = steps < count[:, None]
        info = {**info, "stats": self._aggregate(buf, valid, count, done, params)}
        new_state = MetricsState(inner=inner2, buf=buf, count=count, prev_done=done)
        return obs, new_state, reward, term, trunc, info

    def _aggregate(self, buf, valid, count, done, params):
        denom = count.clamp_min(1).to(torch.float32)
        last = (count - 1).clamp_min(0)
        scalar: dict[str, torch.Tensor] = {}
        for m, b in buf.items():
            avg = (b * valid).sum(dim=-1) / denom
            scalar[f"avg_{m}"] = torch.where(done, avg, float("nan"))
            scalar[f"_avg_{m}"] = done
            scalar[f"final_{m}"] = torch.where(done, _pick(b, last), float("nan"))
            scalar[f"_final_{m}"] = done
        scalar.update(self._extra_stats(buf, valid, count, done, params))
        vector = {**buf, **{f"_{m}": done for m in buf}}
        return {"scalar": scalar, "_scalar": done, "vector": vector, "_vector": done,
                "vector_lengths": count}


@dataclasses.dataclass(frozen=True)
class RegressionMetrics(_MetricsWrapper):
    def _metric_names(self):
        return ("euclidean_distance", "mse")

    def _step_metrics(self, full_action, info, params):
        diff = _target(info) - full_action["prediction"]
        return {"euclidean_distance": norm2(diff), "mse": (diff * diff).mean(dim=-1)}


@dataclasses.dataclass(frozen=True)
class ClassificationMetrics(_MetricsWrapper):
    def _metric_names(self):
        return ("correct_label_prob",)

    def _step_metrics(self, full_action, info, params):
        p = torch.softmax(full_action["prediction"], dim=-1)
        classes = torch.arange(p.shape[-1], device=p.device)
        onehot = classes == _target(info)[:, None].to(torch.int64)
        return {"correct_label_prob": torch.where(onehot, p, 0.0).sum(dim=-1)}

    def _extra_stats(self, buf, valid, count, done, params):
        k = self.env.prediction_space(params).shape[-1]
        chance = float(np.float32(1.0 / k))
        prob = buf["correct_label_prob"]
        steps = torch.arange(prob.shape[-1], dtype=torch.int32, device=prob.device)
        is_correct = (prob > chance) & valid
        acc = is_correct.sum(dim=-1).to(torch.float32) / count.clamp_min(1).to(torch.float32)
        final_correct = _pick(prob, (count - 1).clamp_min(0)) > chance
        first_correct = torch.where(is_correct, steps, 2**30).amin(dim=-1)
        any_correct = is_correct.any(dim=-1)
        incorrect = valid & is_correct.logical_not()
        last_incorrect = torch.where(incorrect, steps, -1).amax(dim=-1)
        return {
            "avg_accuracy": torch.where(done, acc, float("nan")),
            "_avg_accuracy": done,
            "final_accuracy": torch.where(done, final_correct.to(torch.float32), float("nan")),
            "_final_accuracy": done,
            "first_correct": torch.where(any_correct, first_correct, -1).to(torch.int32),
            "_first_correct": done & any_correct,
            "last_incorrect": last_incorrect.to(torch.int32),
            "_last_incorrect": done & incorrect.any(dim=-1),
        }
