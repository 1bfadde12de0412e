"""Plain reference of TinyImageNet-sparse-v0's vector env with its
episode-metric log wrapper, stepped in episodic cycles (LOCKSTEP autoreset
with the boundary hoisted out: one all-env reset step, then 16 steps
without autoreset), written from ap_gym's semantics in plain PyTorch.

The image, the move, the glimpse, the base reward, the dense normalized
cross-entropy and the boundary step are ``reference/image_cls.py``'s,
imported. This module adds what the ``-sparse`` twin and the log wrapper
add on top of them:

* the sparse target's weight: 1.0 where the step terminates, else 0, and 0
  on the boundary step (``sparsify_wrapper.py``: the target becomes
  ``{"target", "weight" = terminated}``);
* the reward ``base - weight * CE``: only an episode's last step is charged
  the prediction loss;
* the info loss: the dense ``CE`` on every step, the boundary's against
  the new image's label (``info["prediction"]["loss"]`` reports the inner
  loss, not the weighted one);
* the episode metrics of ``ActiveClassificationVectorLogWrapper``
  (``active_classification_env.py:89-112,149-197``): each step's
  ``correct_label_prob = softmax(prediction)[label]``, in ``dtype``, kept
  in a 16-entry buffer with a count; the boundary step clears the buffer
  and records nothing, each of the 16 steps records. On done come
  ``avg_`` and ``final_correct_label_prob``, ``avg_`` and
  ``final_accuracy`` (a step is accurate where its probability exceeds
  1/200), ``first_correct`` (the first accurate step) and
  ``last_incorrect`` (the last inaccurate one), -1 where there is none,
  and the validity mask ``_<name>`` of each: done, and for the last two
  done with such a step.

The state is ``reference/image_cls.py``'s dict with ``buf`` (N, 16) in
``dtype`` and ``count`` (N,) int64 added; ``prev_done`` is the previous
step's done, which the vector env and the log wrapper both keep. Floating
statistics read NaN where the env is not done.

Departures from ap_gym, each the port's as well:

* LOCKSTEP autoreset, where ap_gym's vector env resets each env on the
  step after its own end (``reference/image_cls.py``): every episode lasts
  exactly 16 steps, so both reset every env on the same step;
* the wrapper order: the port's metrics wrapper sits above the vector env
  (``ClassificationMetrics(vector_env(Sparsify(env)))``), where ap_gym's
  log wrapper sits inside the sparse wrapper. The log wrapper reads only
  the prediction and the label, which the sparse wrapper does not change,
  so both orders give the same values.
"""

from __future__ import annotations

import torch

from .image_cls import CLASSES, MAX_STEP, SENSOR, STEP_LIMIT, cross_entropy
from .image_cls import boundary_step as dense_boundary_step
from .image_cls import reset as dense_reset
from .image_cls import step as dense_step

__all__ = ["reset", "step", "boundary_step", "correct_label_prob", "statistics", "BUFFER",
           "STATS", "CLASSES", "MAX_STEP", "SENSOR", "STEP_LIMIT"]

BUFFER = STEP_LIMIT  # the log wrapper's buffer: the episode's steps
STATS = ("avg_correct_label_prob", "final_correct_label_prob", "avg_accuracy",
         "final_accuracy", "first_correct", "last_incorrect")


def correct_label_prob(prediction: torch.Tensor, label: torch.Tensor, dtype) -> torch.Tensor:
    """(N,) softmax of the logits ``prediction`` (N, C) at ``label``, in
    ``dtype``."""
    p = torch.softmax(prediction.to(dtype), dim=-1)
    return p.gather(-1, label.to(torch.int64)[:, None])[:, 0]


def _cleared(state: dict, dtype) -> dict:
    n = state["data_index"].shape[0]
    dev = state["data_index"].device
    return {**state, "buf": torch.zeros((n, BUFFER), dtype=dtype, device=dev),
            "count": torch.zeros(n, dtype=torch.int64, device=dev)}


def statistics(buf: torch.Tensor, count: torch.Tensor, done: torch.Tensor,
               classes: int) -> dict:
    """The log wrapper's statistics of the recorded steps ``buf[:, :count]``
    and their validity masks; the floating ones NaN where not ``done``."""
    steps = torch.arange(buf.shape[-1], device=buf.device)
    valid = steps < count[:, None]
    seen = count.clamp_min(1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    final = buf[rows, (count - 1).clamp_min(0)]
    accurate = (buf > 1.0 / classes) & valid
    inaccurate = valid & ~accurate
    nan = torch.full_like(final, float("nan"))
    first = torch.where(accurate, steps, buf.shape[-1]).amin(-1)
    out = {
        "avg_correct_label_prob": torch.where(done, (buf * valid).sum(-1) / seen, nan),
        "final_correct_label_prob": torch.where(done, final, nan),
        "avg_accuracy": torch.where(done, accurate.sum(-1).to(buf.dtype) / seen, nan),
        "final_accuracy": torch.where(done, (final > 1.0 / classes).to(buf.dtype), nan),
        "first_correct": torch.where(accurate.any(-1), first, -1),
        "last_incorrect": torch.where(inaccurate, steps, -1).amax(-1),
    }
    masks = {"first_correct": done & accurate.any(-1), "last_incorrect": done & inaccurate.any(-1)}
    for name in STATS:
        out[f"_{name}"] = masks.get(name, done)
    return out


def reset(bank: torch.Tensor, index: torch.Tensor, pos: torch.Tensor, dtype):
    """(obs, state) of envs reset to image ``index`` at ``pos``, their
    buffers empty."""
    obs, state = dense_reset(bank, index, pos, dtype)
    return obs, _cleared(state, dtype)


def step(bank: torch.Tensor, labels: torch.Tensor, state: dict, action: torch.Tensor,
         prediction: torch.Tensor, positions: list | None = None):
    """One step without autoreset: (obs, state, reward, terminated,
    truncated, info loss, statistics). The step records its probability
    unless the previous step was done (then it clears the buffer)."""
    dt = state["pos"].dtype
    label = labels[state["data_index"]]
    obs, new, dense_reward, terminated, truncated = dense_step(bank, labels, state, action,
                                                               prediction, positions)
    ce = cross_entropy(prediction, label, dt)
    base = dense_reward + ce  # image_cls's reward is base - CE
    reward = base - terminated.to(dt) * ce
    record = ~state["prev_done"]
    count = torch.where(state["prev_done"], 0, state["count"])
    buf = torch.where(state["prev_done"][:, None], 0.0, state["buf"])
    rows = torch.arange(buf.shape[0], device=buf.device)
    slot = count.clamp(max=BUFFER - 1)
    buf[rows, slot] = torch.where(record, correct_label_prob(prediction, label, dt),
                                  buf[rows, slot])
    new = {**new, "buf": buf, "count": count + record.to(torch.int64)}
    done = terminated | truncated
    return (obs, new, reward, terminated, truncated, ce,
            statistics(new["buf"], new["count"], done, prediction.shape[-1]))


def boundary_step(bank: torch.Tensor, labels: torch.Tensor, prediction: torch.Tensor, index,
                  pos, dtype, positions: list | None = None):
    """The all-env reset step: every env reset from the draws, weight 0 so
    reward 0, the info loss against the new image's label, the buffers
    cleared with nothing recorded, no done."""
    obs, new, dense_reward, done, truncated = dense_boundary_step(bank, labels, prediction,
                                                                  index, pos, dtype, positions)
    ce = -dense_reward  # base 0
    new = _cleared(new, dtype)
    return (obs, new, torch.zeros_like(ce), done, truncated, ce,
            statistics(new["buf"], new["count"], done, prediction.shape[-1]))
