"""TinyImageNet-sparse-v0 with its episode-metric wrapper as the benchmark
builds it, draws for it, reads its outputs and checks them.

* The images, the draws and the env's constants are ``image_cls``'s (its
  ``build`` makes the bank and checks the constants, its ``draw_pool`` the
  draws): the ``-sparse`` twin steps the same env with the same logits.
* The env: as ``apx_torch.make_vec("TinyImageNet-sparse-v0", N,
  metrics=True)`` composes the id, over this bank:
  ``ClassificationMetrics(vector_env(Sparsify(ImageClassificationEnv(...)),
  N, LOCKSTEP), buffer_len=16)``. A chunk is one cycle, boundary first: the
  metrics wrapper's ``boundary_reset_step``, then 16 steps of the wrapper
  without autoreset (``with_autoreset(..., DISABLED)``). ``build`` refuses
  a composition other than the configuration's: the loss ``WeightedLossFn``
  over the normalized cross-entropy, a buffer of 16.
* The state a chunk returns is ``{"metrics": the wrapper's state,
  "info_loss_sum", "stats"}``: beside the wrapper's state, the sum over the
  chunk's steps of the dense loss the info reports, and the statistics
  (``info["stats"]["scalar"]``) of the chunk's last step, the episode's
  16th. Both are made anew at the chunk's first step, so the reference
  follows a chunk from its draws alone, as it follows ``image_cls``'s.
"""

from __future__ import annotations

import math

import torch

from ..reference import image_cls_sparse as ref
from ..yardstick.sparse import classification_metrics_least_s, sparse_loss_least_s
from . import image_cls as base
from .image_cls import OBS_KEYS, Env, draw_pool

__all__ = ["Env", "build", "draw_pool", "initial_reset", "step_chunk", "program_leaves",
           "reference_reset", "reference_chunk", "least_seconds", "OBS_KEYS"]


def build(config: dict, traffic: dict, seed: int, dev: torch.device) -> Env:
    from apx_torch.core.env import AutoResetMode, vector_env, with_autoreset
    from apx_torch.wrappers.metrics import ClassificationMetrics
    from apx_torch.wrappers.sparsify import Sparsify

    dense = base.build(config, traffic, seed, dev)  # the bank; raises on other constants
    venv = ClassificationMetrics(
        vector_env(Sparsify(dense.venv.env), traffic["num_envs"], AutoResetMode.LOCKSTEP),
        buffer_len=config["metrics"]["buffer"])
    loss_fn = venv.env.loss_fn(dense.params)
    inner = getattr(loss_fn, "inner", None)
    # The normalization over the configuration's classes: scale 1 / log(C).
    built = (config["metrics"]["kind"], type(loss_fn).__name__, type(inner).__name__,
             type(getattr(inner, "inner", None)).__name__,
             round(getattr(inner, "scale", 0.0) * math.log(config["classes"]), 9),
             getattr(inner, "offset", None), venv.buffer_len)
    stated = ("classification", "WeightedLossFn", "AffineLossFn", "CrossEntropyLossFn", 1.0,
              0.0, config["metrics"]["buffer"])
    judged = stated[:-1] + (ref.BUFFER,)
    if not built == stated == judged:
        raise ValueError(f"(metrics, loss, its inner, the inner's inner, scale x log(classes), "
                         f"offset, buffer): the env has {built}, the configuration {stated}, "
                         f"the reference {judged}")
    return Env(venv=venv, params=dense.params, num_envs=dense.num_envs, chunk=dense.chunk,
               images=dense.images, labels=dense.labels, block=dense.block,
               inner=with_autoreset(venv, AutoResetMode.DISABLED))


def initial_reset(env: Env, gen: torch.Generator, policy):
    """(obs, state, lead): the program's explicit reset from injected
    draws, then the rest of its episode's steps, so that the first chunk
    starts on a boundary; ``lead`` is what the reference follows them
    from (``image_cls.initial_reset``). It is set-up."""
    draws = draw_pool(env, gen, env.chunk)
    obs, metrics, _ = env.venv.reset(env.params, draws=base._reset_draws(draws, 0))
    racc = torch.zeros(env.num_envs, dtype=torch.float32, device=env.images.device)
    obs, state = step_chunk(env, obs, {"metrics": metrics}, {k: v[1:] for k, v in draws.items()},
                            racc, torch.zeros_like(racc, dtype=torch.int32), policy,
                            boundary=False)
    return obs, state, {"draws": draws, "policy": policy}


def step_chunk(env: Env, obs: dict, state: dict, draws: dict, racc: torch.Tensor,
               dacc: torch.Tensor, policy, boundary: bool = True):
    """The chunk's steps (the leading axis of ``draws``) through the
    metrics wrapper: the all-env boundary reset first, from its injected
    draws, then the episode's steps without autoreset; rewards and
    terminations are added into the accumulators in place. Returns (obs,
    the chunk's state; see the module's docstring)."""
    metrics = state["metrics"]
    for j in range(draws["action"].shape[0]):
        full = {"action": policy(draws["action"][j], obs), "prediction": draws["prediction"][j]}
        if boundary and j == 0:
            obs, metrics, reward, term, _, info = env.venv.boundary_reset_step(
                metrics, full, env.params, reset_draws=base._reset_draws(draws, j),
                step_draws={})
        else:
            obs, metrics, reward, term, _, info = env.inner.step(metrics, full, env.params,
                                                                 step_draws={})
        racc.add_(reward)
        dacc.add_(term)
        loss = info["prediction"]["loss"]
        info_loss = loss if j == 0 else info_loss + loss
    return obs, {"metrics": metrics, "info_loss_sum": info_loss,
                 "stats": info["stats"]["scalar"]}


def program_leaves(obs: dict, state: dict) -> dict:
    metrics = state["metrics"]
    p = metrics.inner.inner
    return {**{k: obs[k] for k in OBS_KEYS}, "image": p.image, "label": p.label,
            "data_index": p.data_index, "pos": p.pos, "time": p.time,
            "prev_done": metrics.inner.prev_done, "buf": metrics.buf["correct_label_prob"],
            "count": metrics.count, "metrics_prev_done": metrics.prev_done,
            "info_loss_sum": state["info_loss_sum"],
            **{f"stats.{k}": v for k, v in state["stats"].items()}}


def _follow(env: Env, draws: dict, dtype, policy, boundary: bool, record: dict | None = None):
    """The reference through the steps of ``draws`` (leading step axis),
    block by block of envs, as ``image_cls._follow``: the boundary step
    first where ``boundary``, else the explicit reset from the first step's
    reset draws; then the episode's steps. Returns the outputs by
    ``program_leaves``' names, with the reward sums and termination counts,
    concatenated over the blocks."""
    n = draws["action"].shape[1]
    dev = env.images.device
    blocks = [slice(i, min(i + env.block, n)) for i in range(0, n, env.block)]
    obs: list = [None] * len(blocks)
    states: list = [None] * len(blocks)
    stats: list = [None] * len(blocks)
    sums = {k: [torch.zeros(b.stop - b.start, dtype=t, device=dev) for b in blocks]
            for k, t in (("reward_sum", dtype), ("term_count", torch.int64),
                         ("info_loss_sum", dtype))}
    launches: list[torch.Tensor] = []
    for j in range(draws["action"].shape[0]):
        act = None if j == 0 else policy(draws["action"][j], obs[0])
        seen: list[list[torch.Tensor]] = []
        for i, b in enumerate(blocks):
            got: list[torch.Tensor] = []
            pred = draws["prediction"][j][b]
            if j > 0:
                out = ref.step(env.images, env.labels, states[i], act[b], pred, got)
            elif boundary:
                out = ref.boundary_step(env.images, env.labels, pred, draws["index"][j][b],
                                        draws["pos"][j][b], dtype, got)
            else:
                obs[i], states[i] = ref.reset(env.images, draws["index"][j][b],
                                              draws["pos"][j][b], dtype)
                seen.append(got)
                continue
            obs[i], states[i], reward, term, _, info_loss, stats[i] = out
            sums["reward_sum"][i] += reward
            sums["term_count"][i] += term
            sums["info_loss_sum"][i] += info_loss
            seen.append(got)
        launches += [torch.cat(parts) for parts in zip(*seen)]
    if record is not None:
        record["glimpse_pos"] = launches
    out = {k: torch.cat([o[k] for o in obs]) for k in OBS_KEYS}
    for k in ("data_index", "pos", "time", "prev_done", "buf", "count"):
        out[k] = torch.cat([s[k] for s in states])
    out["metrics_prev_done"] = out["prev_done"]
    out["image"] = env.images[out["data_index"]]
    out["label"] = env.labels[out["data_index"]]
    out.update({k: torch.cat(v) for k, v in sums.items()})
    out.update({f"stats.{k}": torch.cat([s[k] for s in stats]) for k in stats[0]})
    return out


def reference_reset(env: Env, lead: dict, dtype) -> dict:
    """The reference's outputs of the explicit reset and its episode's
    steps, from ``initial_reset``'s ``lead``: the ones ``program_leaves``
    names (the info-loss sum over the episode's 16 steps)."""
    out = _follow(env, lead["draws"], dtype, lead["policy"], boundary=False)
    del out["reward_sum"], out["term_count"]
    return out


def reference_chunk(env: Env, before: dict, draws: dict, prev_draws: dict | None, dtype, policy,
                    record: dict | None = None) -> dict:
    """The reference's outputs after the chunk whose draws are ``draws``
    (leading step axis): the boundary reset from its first draws (weight
    0, its info loss against the new labels, the buffers cleared), then the
    episode's steps, the last charged the loss. Nothing of the state
    ``before`` the chunk, nor of the previous chunk's draws, is read. With
    ``record``, each glimpse launch's positions go to
    ``record["glimpse_pos"]``."""
    return _follow(env, draws, dtype, policy, boundary=True, record=record)


def least_seconds(env: Env, record: dict) -> dict:
    """Least seconds per vector step of the chunk's glimpses
    (``image_cls``'s), of the sparse loss and of the classification
    metrics (``yardstick.sparse``)."""
    n, classes = env.num_envs, env.params.dataset.num_classes
    out = {"sparse_loss": sparse_loss_least_s(n, classes),
           "classification_metrics": classification_metrics_least_s(n, classes,
                                                                    env.venv.buffer_len)}
    glimpse = base.least_seconds(env, record).get("glimpse")
    if glimpse is not None:
        out["glimpse"] = glimpse
    return out
