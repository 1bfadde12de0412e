"""TinyImageNetLoc-v0 as the benchmark builds it, draws for it, reads its
outputs and checks them.

* The images: the configuration's ``bank_images`` uint8 images of its
  shape, and their labels, made from the seed on the device; the program
  gets them as its image bank (``BankImageDataset``), the reference as they
  are.
* The env: ``ImageLocalizationEnv`` with the id's 10x10 sensor, as
  ``apx_torch.make_vec`` builds the id but over this bank, with the
  configuration's unique-target sampler; LOCKSTEP autoreset stepped in
  episodic cycles. A chunk is one cycle, boundary first: the all-env reset
  step (``boundary_reset_step``), then 16 steps without autoreset, so that
  a chunk ends on the episode's last step and its outputs are the moves and
  glimpses of a whole episode. The explicit reset (which runs the sampler's
  sweep) and the first episode's 16 steps (their draws made from the seed
  after the pool's) are set-up.
* The draws of a step: the policy's action and prediction, and the
  boundary reset's image index, position and target (the autoreset's
  uniform target).
* The check: every env is reset at a chunk's first step, so the reference
  needs nothing of the program's state: it starts from the previous
  chunk's boundary draws (the episode's target, which the boundary's loss
  reads) and this chunk's draws.
"""

from __future__ import annotations

import dataclasses

import torch

from ..reference import image_loc as ref
from ..yardstick.bounds import glimpse_least_s

__all__ = ["Env", "build", "draw_pool", "initial_reset", "step_chunk", "program_leaves",
           "reference_chunk", "least_seconds", "OBS_KEYS"]

OBS_KEYS = ("glimpse", "glimpse_pos", "target_glimpse", "time_step")
RESET_KEYS = ("index", "inverted", "pos", "target")


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
    from apx_torch.envs.image_localization import ImageLocalizationEnv

    gen = torch.Generator(dev).manual_seed(seed)
    h, w, c = config["image_shape"]
    images = torch.randint(0, 256, (config["bank_images"], h, w, c), generator=gen, device=dev,
                           dtype=torch.uint8)
    labels = torch.randint(0, config["classes"], (config["bank_images"],), generator=gen,
                           device=dev)
    env = ImageLocalizationEnv(dataset=BankImageDataset(images, labels, config["classes"]),
                               sensor_size=tuple(config["sensor_size"]))
    params = env.default_params(unique_sampling_backend=config["unique_sampling_backend"])
    stated = (config["step_limit"], (config["max_step_length"],) * 2)
    built = (params.step_limit, tuple(params.max_step_length))
    if built != stated:
        raise ValueError(f"the env has (step limit, max step) {built}, the configuration "
                         f"{stated}")
    venv = vector_env(env, traffic["num_envs"], AutoResetMode.LOCKSTEP)
    return Env(venv=venv, params=params, num_envs=traffic["num_envs"],
               chunk=config["step_limit"] + 1, images=images, labels=labels,
               block=traffic["check_block_envs"],
               inner=with_autoreset(venv, AutoResetMode.DISABLED))


def draw_pool(env: Env, gen: torch.Generator, steps: int) -> dict:
    """The draws of ``steps`` steps, each with a leading step axis: actions
    uniform in [-1, 1), standard-normal predictions, the reset's image index
    uniform over the bank, no label inversion, position and target uniform
    in [-1, 1)^2."""
    n, dev = env.num_envs, env.images.device
    return {"action": torch.rand((steps, n, 2), generator=gen, device=dev) * 2.0 - 1.0,
            "prediction": torch.randn((steps, n, 2), generator=gen, device=dev),
            "index": torch.randint(0, env.images.shape[0], (steps, n), generator=gen,
                                   device=dev),
            "inverted": torch.zeros((steps, n), dtype=torch.bool, device=dev),
            "pos": torch.rand((steps, n, 2), generator=gen, device=dev) * 2.0 - 1.0,
            "target": torch.rand((steps, n, 2), generator=gen, device=dev) * 2.0 - 1.0}


def initial_reset(env: Env, gen: torch.Generator, policy):
    """(obs, state, None): the program's explicit reset, its draws (the
    unique-target sampler's among them) from ``gen``, and the rest of its
    episode's steps, so that the first chunk starts on a boundary. It is
    set-up, and the check starts from a boundary reset."""
    obs, state, _ = env.venv.reset(env.params, gen)
    lead = draw_pool(env, gen, env.chunk)
    n = env.num_envs
    racc = torch.zeros(n, dtype=torch.float32, device=env.images.device)
    obs, state = step_chunk(env, obs, state, {k: v[1:] for k, v in lead.items()}, racc,
                            torch.zeros_like(racc, dtype=torch.int32), policy, boundary=False)
    return obs, state, None


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
                state, full, env.params, reset_draws={k: draws[k][j] for k in RESET_KEYS},
                step_draws={})
        else:
            obs, state, reward, term, *_ = env.inner.step(state, full, env.params,
                                                          step_draws={})
        racc.add_(reward)
        dacc.add_(term)
    return obs, state


def program_leaves(obs: dict, state) -> dict:
    inner = state.inner
    p = inner.perception
    return {**{k: obs[k] for k in OBS_KEYS},
            "image": p.image, "label": p.label, "data_index": p.data_index, "pos": p.pos,
            "time": p.time, "target": inner.target, "state_target_glimpse": inner.target_glimpse,
            "prev_done": state.prev_done}


def reference_chunk(env: Env, before: dict, draws: dict, prev_draws: dict, dtype, policy,
                    record: dict | None = None) -> dict:
    """The reference's outputs after the chunk whose draws are ``draws``
    (leading step axis): the boundary reset from this chunk's first draws
    (its loss against the target of the previous chunk's boundary draws),
    then the episode's steps. With ``record``, each glimpse launch's
    positions go to ``record["glimpse_pos"]``."""
    n = draws["action"].shape[1]
    dev = env.images.device
    blocks = [slice(i, min(i + env.block, n)) for i in range(0, n, env.block)]
    states = [{"target": prev_draws["target"][0][b].to(dtype),
               "pos": prev_draws["pos"][0][b].to(dtype),
               "prev_done": torch.ones(b.stop - b.start, dtype=torch.bool, device=dev)}
              for b in blocks]
    obs = [None] * len(blocks)
    rsum = [torch.zeros(b.stop - b.start, dtype=dtype, device=dev) for b in blocks]
    tcount = [torch.zeros(b.stop - b.start, dtype=torch.int64, device=dev) for b in blocks]
    launches: list[list[torch.Tensor]] = []
    for j in range(draws["action"].shape[0]):
        act = None if j == 0 else policy(draws["action"][j], obs[0])
        seen: list[list[torch.Tensor]] = []
        for i, b in enumerate(blocks):
            got: list[torch.Tensor] = []
            pred = draws["prediction"][j][b]
            if j == 0:
                obs[i], states[i], reward, term, _ = ref.boundary_step(
                    env.images, states[i], pred, draws["index"][j][b], draws["pos"][j][b],
                    draws["target"][j][b], got)
            else:
                obs[i], states[i], reward, term, _ = ref.step(env.images, states[i], act[b],
                                                              pred, got)
            rsum[i] += reward
            tcount[i] += term
            seen.append(got)
        launches += [torch.cat(parts) for parts in zip(*seen)]
    if record is not None:
        record["glimpse_pos"] = launches
    out = {k: torch.cat([o[k] for o in obs]) for k in OBS_KEYS}
    for k in ("data_index", "pos", "time", "target", "prev_done"):
        out[k] = torch.cat([s[k] for s in states])
    out["state_target_glimpse"] = out["target_glimpse"]
    out["image"] = env.images[out["data_index"]]
    out["label"] = env.labels[out["data_index"]]
    out["reward_sum"] = torch.cat(rsum)
    out["term_count"] = torch.cat(tcount)
    return out


def least_seconds(env: Env, record: dict) -> dict:
    """Least seconds per vector step of the chunk's glimpses (each step's,
    and the boundary's target and position glimpses) at the positions the
    reference took them."""
    if "glimpse_pos" not in record:
        return {}
    shape = tuple(env.images.shape[1:])
    sensor = tuple(env.params.sensor_size)
    total = sum(glimpse_least_s(p, shape, sensor) for p in record["glimpse_pos"])
    return {"glimpse": total / env.chunk}
