"""TinyImageNet-v0 as the benchmark builds it, draws for it, reads its
outputs and checks them.

* The images: the configuration's ``bank_images`` uint8 images of its
  shape, and their labels over its ``classes``, made from the seed on the
  device; the program gets them as its image bank (``BankImageDataset``),
  the reference as they are.
* The env: ``ImageClassificationEnv`` with the id's 10x10 sensor, as
  ``apx_torch.make_vec`` builds the id but over this bank; LOCKSTEP
  autoreset stepped in episodic cycles. A chunk is one cycle, boundary
  first: the all-env reset step (``boundary_reset_step``), then 16 steps
  without autoreset, so that a chunk ends on the episode's last step. The
  explicit reset and the first episode's 16 steps, their draws made from
  the seed after the pool's, are set-up.
* The draws of a step: the policy's action, its prediction (the logits of
  every class, standard normal), and the boundary reset's image index and
  position. The label of the drawn image is the target: nothing else is
  drawn for it.
* The check: every env is reset at a chunk's first step and the boundary's
  loss is against the new image's label, so the reference follows a chunk
  from its draws alone. The explicit reset with its episode's steps, and
  the first warm chunk after them, are followed from their draws too.
"""

from __future__ import annotations

import dataclasses

import torch

from ..reference import image_cls as ref
from ..yardstick.bounds import glimpse_least_s
from ..yardstick.loss import cross_entropy_least_s

__all__ = ["Env", "build", "draw_pool", "initial_reset", "step_chunk", "program_leaves",
           "reference_reset", "reference_chunk", "least_seconds", "OBS_KEYS"]

OBS_KEYS = ("glimpse", "glimpse_pos", "time_step")
RESET_KEYS = ("index", "inverted", "pos")


@dataclasses.dataclass
class Env:
    venv: object
    params: object
    num_envs: int
    chunk: int
    images: torch.Tensor  # (D, H, W, C) uint8
    labels: torch.Tensor  # (D,) int64
    block: int
    inner: object  # the vector env without autoreset: an episode's steps


def build(config: dict, traffic: dict, seed: int, dev: torch.device) -> Env:
    from apx_torch.core.env import AutoResetMode, vector_env, with_autoreset
    from apx_torch.data.dataset import BankImageDataset
    from apx_torch.envs.image_classification import ImageClassificationEnv

    gen = torch.Generator(dev).manual_seed(seed)
    h, w, c = config["image_shape"]
    images = torch.randint(0, 256, (config["bank_images"], h, w, c), generator=gen, device=dev,
                           dtype=torch.uint8)
    labels = torch.randint(0, config["classes"], (config["bank_images"],), generator=gen,
                           device=dev)
    env = ImageClassificationEnv(dataset=BankImageDataset(images, labels, config["classes"]),
                                 sensor_size=tuple(config["sensor_size"]))
    params = env.default_params()
    stated = (tuple(config["sensor_size"]), config["step_limit"],
              (config["max_step_length"],) * 2, False, config["classes"])
    built = (tuple(params.sensor_size), params.step_limit, tuple(params.max_step_length),
             params.randomly_invert_labels, params.dataset.num_classes)
    judged = (ref.SENSOR, ref.STEP_LIMIT, (ref.MAX_STEP,) * 2, False, ref.CLASSES)
    if not built == stated == judged:
        raise ValueError(f"(sensor, step limit, max step, inverted labels, classes): the env "
                         f"has {built}, the configuration {stated}, the reference {judged}")
    venv = vector_env(env, traffic["num_envs"], AutoResetMode.LOCKSTEP)
    return Env(venv=venv, params=params, num_envs=traffic["num_envs"],
               chunk=config["step_limit"] + 1, images=images, labels=labels,
               block=traffic["check_block_envs"],
               inner=with_autoreset(venv, AutoResetMode.DISABLED))


def draw_pool(env: Env, gen: torch.Generator, steps: int) -> dict:
    """The draws of ``steps`` steps, each with a leading step axis: actions
    uniform in [-1, 1), standard-normal logits of every class, the reset's
    image index uniform over the bank, no label inversion, and its position
    uniform in [-1, 1)^2."""
    n, dev = env.num_envs, env.images.device
    return {"action": torch.rand((steps, n, 2), generator=gen, device=dev) * 2.0 - 1.0,
            "prediction": torch.randn((steps, n, env.params.dataset.num_classes), generator=gen,
                                      device=dev),
            "index": torch.randint(0, env.images.shape[0], (steps, n), generator=gen,
                                   device=dev),
            "inverted": torch.zeros((steps, n), dtype=torch.bool, device=dev),
            "pos": torch.rand((steps, n, 2), generator=gen, device=dev) * 2.0 - 1.0}


def _reset_draws(draws: dict, j: int) -> dict:
    return {k: draws[k][j] for k in RESET_KEYS}


def initial_reset(env: Env, gen: torch.Generator, policy):
    """(obs, state, lead): the program's explicit reset from injected
    draws, then the rest of its episode's steps, so that the first chunk
    starts on a boundary. ``lead`` is what the reference follows them from:
    their ``draws`` (a chunk's, the first step's reset draws being the
    explicit reset's) and the ``policy``. It is set-up."""
    draws = draw_pool(env, gen, env.chunk)
    obs, state, _ = env.venv.reset(env.params, draws=_reset_draws(draws, 0))
    n = env.num_envs
    racc = torch.zeros(n, dtype=torch.float32, device=env.images.device)
    obs, state = step_chunk(env, obs, state, {k: v[1:] for k, v in draws.items()}, racc,
                            torch.zeros_like(racc, dtype=torch.int32), policy, boundary=False)
    return obs, state, {"draws": draws, "policy": policy}


def step_chunk(env: Env, obs: dict, state, draws: dict, racc: torch.Tensor,
               dacc: torch.Tensor, policy, boundary: bool = True):
    """The chunk's steps (the leading axis of ``draws``): the all-env
    boundary reset first, from its injected draws, then the episode's steps
    without autoreset; rewards and terminations are added into the
    accumulators in place."""
    for j in range(draws["action"].shape[0]):
        full = {"action": policy(draws["action"][j], obs), "prediction": draws["prediction"][j]}
        if boundary and j == 0:
            obs, state, reward, term, *_ = env.venv.boundary_reset_step(
                state, full, env.params, reset_draws=_reset_draws(draws, j), step_draws={})
        else:
            obs, state, reward, term, *_ = env.inner.step(state, full, env.params,
                                                          step_draws={})
        racc.add_(reward)
        dacc.add_(term)
    return obs, state


def program_leaves(obs: dict, state) -> dict:
    p = state.inner
    return {**{k: obs[k] for k in OBS_KEYS}, "image": p.image, "label": p.label,
            "data_index": p.data_index, "pos": p.pos, "time": p.time,
            "prev_done": state.prev_done}


def _follow(env: Env, draws: dict, dtype, policy, boundary: bool, record: dict | None = None):
    """The reference through the steps of ``draws`` (leading step axis),
    block by block of envs: the boundary step first where ``boundary``,
    else the explicit reset from the first step's reset draws; then the
    episode's steps. Returns (the outputs by ``program_leaves``' names,
    reward sums, termination counts), concatenated over the blocks."""
    n = draws["action"].shape[1]
    dev = env.images.device
    blocks = [slice(i, min(i + env.block, n)) for i in range(0, n, env.block)]
    obs: list = [None] * len(blocks)
    states: list = [None] * len(blocks)
    rsum = [torch.zeros(b.stop - b.start, dtype=dtype, device=dev) for b in blocks]
    tcount = [torch.zeros(b.stop - b.start, dtype=torch.int64, device=dev) for b in blocks]
    launches: list[torch.Tensor] = []
    for j in range(draws["action"].shape[0]):
        act = None if j == 0 else policy(draws["action"][j], obs[0])
        seen: list[list[torch.Tensor]] = []
        for i, b in enumerate(blocks):
            got: list[torch.Tensor] = []
            pred = draws["prediction"][j][b]
            if j > 0:
                obs[i], states[i], reward, term, _ = ref.step(env.images, env.labels, states[i],
                                                              act[b], pred, got)
            elif boundary:
                obs[i], states[i], reward, term, _ = ref.boundary_step(
                    env.images, env.labels, pred, draws["index"][j][b], draws["pos"][j][b],
                    dtype, got)
            else:
                obs[i], states[i] = ref.reset(env.images, draws["index"][j][b],
                                              draws["pos"][j][b], dtype)
                reward = term = None
            if reward is not None:
                rsum[i] += reward
                tcount[i] += term
            seen.append(got)
        launches += [torch.cat(parts) for parts in zip(*seen)]
    if record is not None:
        record["glimpse_pos"] = launches
    out = {k: torch.cat([o[k] for o in obs]) for k in OBS_KEYS}
    for k in ("data_index", "pos", "time", "prev_done"):
        out[k] = torch.cat([s[k] for s in states])
    out["image"] = env.images[out["data_index"]]
    out["label"] = env.labels[out["data_index"]]
    return out, torch.cat(rsum), torch.cat(tcount)


def reference_reset(env: Env, lead: dict, dtype) -> dict:
    """The reference's outputs of the explicit reset and its episode's
    steps, from ``initial_reset``'s ``lead``."""
    out, _, _ = _follow(env, lead["draws"], dtype, lead["policy"], boundary=False)
    return out


def reference_chunk(env: Env, before: dict, draws: dict, prev_draws: dict | None, dtype, policy,
                    record: dict | None = None) -> dict:
    """The reference's outputs after the chunk whose draws are ``draws``
    (leading step axis): the boundary reset from its first draws (its loss
    against the new labels), then the episode's steps. Nothing of the state
    ``before`` the chunk, nor of the previous chunk's draws, is read. With
    ``record``, each glimpse launch's positions go to
    ``record["glimpse_pos"]``."""
    out, rsum, tcount = _follow(env, draws, dtype, policy, boundary=True, record=record)
    return {**out, "reward_sum": rsum, "term_count": tcount}


def least_seconds(env: Env, record: dict) -> dict:
    """Least seconds per vector step of the chunk's glimpses (each step's,
    and the boundary's), at the positions the reference took them, and of
    the step's cross-entropy loss and reward (``yardstick.loss``)."""
    out = {"cross_entropy": cross_entropy_least_s(env.num_envs,
                                                  env.params.dataset.num_classes)}
    if "glimpse_pos" in record:
        shape = tuple(env.images.shape[1:])
        sensor = tuple(env.params.sensor_size)
        out["glimpse"] = sum(glimpse_least_s(p, shape, sensor)
                             for p in record["glimpse_pos"]) / env.chunk
    return out
