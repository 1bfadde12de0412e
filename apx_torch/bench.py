"""Throughput bench of the port's main paths at N=4096.

Seven workloads, each the counterpart of one of the JAX package's
``bench.py`` workloads or of one of its backends, with its random
policy: uniform actions in [-1, 1] and standard-normal predictions
(logits for CircleSquare). As there, the policy's draws are hoisted out of
the stepping loop, and one element of every observation leaf is folded
into the next action (times 1e-12) so each step depends on the previous
step's observation. The reset draws and the step draws are hoisted too,
and injected, so a captured graph holds no generator.

* ``lidar_rooms``: ``TimeLimit(LIDARLocalizationEnv(rooms bank, 256
  maps), 100, issue_termination=True)`` under NEXT_STEP autoreset
  (``bench.py:344-360`` of the JAX package);
* ``lidar_rooms_window``: the same env with ``raycast_backend=
  "pallas_window"``: every cast runs on a (24, 16) window that K2 cuts per
  env, with the same policy, loops and chunking as ``lidar_rooms``;
* ``circle_square``: ``ImageClassificationEnv(CircleSquare bank)`` under
  LOCKSTEP autoreset (``bench.py:323-331``), stepped as apx's bench steps
  it: episodic cycles of 16 DISABLED steps and one
  ``boundary_reset_step``, the step count rounded to whole 17-step cycles.
  The masked-merge ``venv.step`` loop, which runs the reset (an image
  gather and a second glimpse) on every step, is timed beside it;
* ``light_dark``: a bare ``LightDarkEnv()`` under NEXT_STEP autoreset,
  apx's ``make_light_dark`` (``bench.py:334-341``): not a registered id
  (no TimeLimit), so its workload names a builder. It runs no kernel of
  the port; its step draws its observation noise;
* ``tin_loc``: ``ImageLocalizationEnv`` over a synthetic TinyImageNet bank
  of 100,000 images (apx's banked size, 1.23 GB of uint8 on the card),
  10x10 sensor, LOCKSTEP (``bench.py:389-451``), stepped as
  ``circle_square``. Its explicit reset, which runs the unique-target
  sampler's sweep, is timed on its own (``reset_ms``, with the peak of
  ``max_memory_allocated``);
* ``mnist``: ``MNIST-v0``'s ``ImageClassificationEnv`` over a synthetic
  MNIST bank of 60,000 images (28x28x1 uint8, 5x5 sensor), as
  ``circle_square``;
* ``hide_and_seek``: ``make_vec("CircleSquareHideAndSeek-v0")``, the
  vector-level reward wrapper over a 32-step CircleSquare env, as
  ``circle_square``.

The synthetic banks are built on the host once per process; the seconds
it took are printed (``bank_build_s``).

Two loops are timed per workload, each after a warmup run and each ending
on a value fetch of the summed rewards:

* eager: the steps called from Python;
* graph: one chunk of steps (16 for LIDAR, one 17-step cycle for
  CircleSquare) captured in a CUDA graph and replayed. A capture that
  fails raises.

    python -m apx_torch.bench [--env lidar_rooms|lidar_rooms_window|circle_square|light_dark
                                     |tin_loc|mnist|hide_and_seek]
        [--num-envs 4096] [--num-steps 1024] [--profile]

prints one JSON line with ``<env>_env_steps_per_s`` (the graph loop),
``<env>_eager_env_steps_per_s``, ``num_envs``, ``device_kind`` and
``power_limit_w``. ``--profile`` instead traces ``PROFILE_STEPS`` eager
steps with ``torch.profiler`` and prints where the device time goes;
``--trace DIR`` also writes that trace and a trace of four replays of
the captured graph chunk as chrome JSON (``DIR/eager.json``,
``DIR/graph.json``) for ``python -m apx_torch.tools.parse_trace``. It
runs on the card only.

    python -m apx_torch.bench --compat [--env lidar_rooms|circle_square]

times the gymnasium drop-in adapter's core (``apx_torch.compat``, the
counterpart of the JAX package's ``bench_compat``, ``bench.py:509-548``):
``rng="native"``, no log wrapper, 8 rotating numpy action batches, a
warmup that crosses a done and one step beyond it, then 64 timed steps
from a fresh reset. Each step uploads the actions, steps eagerly on the
card, copies the host-visible outputs in one transfer and composes the
reward on the host. It prints a per-step breakdown line (median over 64
more steps with timing on), then ``<env>_compat_env_steps_per_s``. The
core is what ``make_vec`` returns wrapped in gymnasium classes, which the
GPU machine lacks; the shells only delegate.

    python -m apx_torch.bench --env lidar_rooms --raycast-backend bitslab2d
        [--beam-rects on] | --beam-tables
    python -m apx_torch.bench --env tin_loc --image-storage packed|flat|gather
        | --glimpse-window rows | --sampler streamed [--num-envs 16384]

A/B one of apx's switches against the workload's default, in one process,
interleaved default, variant, variant, default (``bench_ab``): the graph
loop's ms per step of each run, or, for ``--sampler``, the explicit
reset's ms and peak memory. With ``--profile`` the switch applies to the
profiled loop instead.

    torchrun --standalone --nproc_per_node=K -m apx_torch.bench --distributed
        [--env ...] [--num-envs 4096] [--backend nccl|gloo] [--device cuda] [--shard-bank]

runs ``bench_sharded`` on K ranks, one card each (``cuda:LOCAL_RANK``),
over nccl: the same loops on each rank's block of ``--num-envs`` envs,
and rank 0 prints ``<env>_sharded_env_steps_per_s`` beside the plain
loop's rate. Two ranks on one card: ``--nproc_per_node=2 --backend gloo
--device cuda:0`` (NCCL refuses two ranks on one GPU). ``--shard-bank``
runs ``bench_sharded_bank`` instead: the eager loop with the bank
replicated and sharded over the ranks, and the bytes its fetches move.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .core.env import AutoResetMode, VectorAPEnv, tree_map, vector_env, with_autoreset
from .data.huggingface import synthetic_image_bank
from .envs.image_classification import ImageClassificationEnv
from .envs.image_localization import ImageLocalizationEnv
from .envs.light_dark import LightDarkEnv
from .registry import make_vec

__all__ = ["bench_lidar_rooms", "bench_lidar_rooms_window", "bench_light_dark",
           "bench_lockstep", "bench_sharded", "bench_sharded_bank", "bench_ab", "bench_compat",
           "graph_chunk", "profile", "profile_graph", "nvidia_smi_line", "AB_SWITCHES", "CHUNK",
           "COMPAT_IDS", "WORKLOADS"]

CHUNK = 16  # NEXT_STEP steps per captured graph
PROFILE_STEPS = 34
PROFILE_CHUNKS = 4  # graph replays traced by profile_graph


def _registered(env_id: str, **fixed):
    """Builder of a registered id; under ``use_beam_tables=True`` its map
    bank gets the beam face tables that the switch reads."""
    def build(num_envs, dev, **overrides):
        venv, params = make_vec(env_id, num_envs, device=dev, **fixed, **overrides)
        if overrides.get("use_beam_tables"):
            params = dataclasses.replace(params, map_bank=params.map_bank.with_beam_tables())
        return venv, params

    return build


def _light_dark(num_envs: int, dev, **overrides):
    env = LightDarkEnv(dev)
    return vector_env(env, num_envs, AutoResetMode.NEXT_STEP), env.default_params(**overrides)


_BANKS: dict = {}
BANK_BUILD_S: dict[str, float] = {}


def _synthetic_bank(name: str, num_points: int, dev):
    """apx's synthetic bank of ``num_points`` images, built once per
    process; its build seconds go to ``BANK_BUILD_S``."""
    key = (name, num_points, str(dev))
    if key not in _BANKS:
        t0 = time.perf_counter()
        _BANKS[key] = synthetic_image_bank(name, num_points=num_points, device=dev)
        BANK_BUILD_S[name] = time.perf_counter() - t0
        print(f"bench: synthetic {name} bank of {num_points} images built in "
              f"{BANK_BUILD_S[name]:.1f} s", file=sys.stderr, flush=True)
    return _BANKS[key]


def _tin_loc(num_envs: int, dev, **overrides):
    env = ImageLocalizationEnv(dataset=_synthetic_bank("zh-plus/tiny-imagenet", 100_000, dev),
                               sensor_size=(10, 10))
    return vector_env(env, num_envs, AutoResetMode.LOCKSTEP), env.default_params(**overrides)


def _mnist(num_envs: int, dev, **overrides):
    env = ImageClassificationEnv(dataset=_synthetic_bank("mnist", 60_000, dev))
    return vector_env(env, num_envs, AutoResetMode.LOCKSTEP), env.default_params(**overrides)


# Workload -> (what it runs, builder (num_envs, device) -> (venv, params)).
WORKLOADS = {
    "lidar_rooms": ("LIDARLocRooms-v0", _registered("LIDARLocRooms-v0")),
    "lidar_rooms_window": ("LIDARLocRooms-v0, raycast_backend='pallas_window'",
                           _registered("LIDARLocRooms-v0", raycast_backend="pallas_window")),
    "circle_square": ("CircleSquare-v0", _registered("CircleSquare-v0")),
    "light_dark": ("LightDarkEnv() under NEXT_STEP", _light_dark),
    "tin_loc": ("ImageLocalizationEnv(synthetic TinyImageNet bank, 100000 images, sensor 10x10)",
                _tin_loc),
    "mnist": ("ImageClassificationEnv(synthetic MNIST bank, 60000 images)", _mnist),
    "hide_and_seek": ("CircleSquareHideAndSeek-v0", _registered("CircleSquareHideAndSeek-v0")),
}
LOCKSTEP_WORKLOADS = ("circle_square", "tin_loc", "mnist", "hide_and_seek")
# Device kernels of the port, by a substring of their names in a trace.
PORT_KERNELS = {"raycast": "raycast_kernel", "glimpse": "glimpse_kernel",
                "window": "window_kernel"}


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    """The first card's ``query`` fields as nvidia-smi reports them, by
    default its name and power limit, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@dataclasses.dataclass(frozen=True)
class _Loop:
    """How a workload is stepped: ``venv.step`` every step, or (``period``
    set) episodic cycles of ``period`` steps of ``inner`` (DISABLED) and one
    ``venv.boundary_reset_step``. ``chunk`` steps make one captured graph."""

    venv: VectorAPEnv
    params: Any
    chunk: int
    reset_keys: tuple[str, ...]  # names of the env's reset draws
    step_keys: tuple[str, ...]  # names of the env's step draws
    period: int | None = None
    inner: VectorAPEnv | None = None


def _loop(env: str, num_envs: int, dev, episodic: bool = True, overrides=None,
          sharding=None) -> _Loop:
    """The workload's loop, its params built with ``overrides`` (an A/B
    switch); with a ``sharding`` and ``overrides["shard_bank"]`` its bank is
    sharded over the ranks (``shard_params(shard_leading=True)``)."""
    overrides = dict(overrides or {})
    shard_bank = overrides.pop("shard_bank", False)
    if shard_bank:  # built on the host: only this rank's block reaches the device
        from .distrib import shard_params

        venv, params = WORKLOADS[env][1](num_envs, torch.device("cpu"), **overrides)
        params = shard_params(sharding, params, shard_leading=True)
        if params.device != sharding.device:
            raise ValueError(f"{env} has no bank to shard")
        dev = params.device
    else:
        venv, params = WORKLOADS[env][1](num_envs, dev, **overrides)
    g = torch.Generator(dev)
    keys = (tuple(sorted(venv.env.draw_reset(1, params, g))),
            tuple(sorted(venv.env.draw_step(1, params, g))))
    if venv.autoreset is AutoResetMode.LOCKSTEP and episodic:
        inner = with_autoreset(venv, AutoResetMode.DISABLED)
        return _Loop(venv, params, params.step_limit + 1, *keys, params.step_limit, inner)
    chunk = params.step_limit + 1 if venv.autoreset is AutoResetMode.LOCKSTEP else CHUNK
    return _Loop(venv, params, chunk, *keys)


def _draws(lp: _Loop, num_steps: int, generator: torch.Generator) -> tuple[torch.Tensor, ...]:
    """Hoisted policy, reset and step draws for ``num_steps`` steps, each
    with a leading step axis: (actions, predictions, *reset draws by name,
    *step draws by name)."""
    venv, params = lp.venv, lp.params
    n, dev = venv.num_envs, params.device
    pred_shape = venv.env.prediction_space(params).shape
    act = torch.rand((num_steps, n, 2), generator=generator, device=dev) * 2.0 - 1.0
    pred = torch.randn((num_steps, n, *pred_shape), generator=generator, device=dev)
    resets = [venv.env.draw_reset(n, params, generator) for _ in range(num_steps)]
    steps = [venv.env.draw_step(n, params, generator) for _ in range(num_steps)]
    return (act, pred, *(torch.stack([d[k] for d in resets]) for k in lp.reset_keys),
            *(torch.stack([d[k] for d in steps]) for k in lp.step_keys))


def _probe(obs) -> torch.Tensor:
    """One element of every observation leaf, summed (bench.py's probe)."""
    return sum(leaf.reshape(-1)[0].to(torch.float32) for leaf in obs.values())


def _steps(lp: _Loop, obs, state, draws, rsum):
    """Step through the leading axis of the hoisted draws, which starts at
    a cycle boundary; adds each step's summed reward into ``rsum`` in
    place."""
    act, pred, *drawn = draws
    reset, stepd = drawn[:len(lp.reset_keys)], drawn[len(lp.reset_keys):]
    for j in range(act.shape[0]):
        a = (act[j] + _probe(obs) * 1e-12).clamp(-1.0, 1.0)
        full = {"action": a, "prediction": pred[j]}
        reset_draws = {k: v[j] for k, v in zip(lp.reset_keys, reset)}
        step_draws = {k: v[j] for k, v in zip(lp.step_keys, stepd)}
        if lp.period is None:
            obs, state, reward, *_ = lp.venv.step(state, full, lp.params, reset_draws=reset_draws,
                                                  step_draws=step_draws)
        elif j % (lp.period + 1) == lp.period:
            obs, state, reward, *_ = lp.venv.boundary_reset_step(
                state, full, lp.params, reset_draws=reset_draws, step_draws=step_draws)
        else:
            obs, state, reward, *_ = lp.inner.step(state, full, lp.params, step_draws=step_draws)
        rsum += reward.sum()
    return obs, state


def _finish(rsum: torch.Tensor, sharding=None) -> None:
    """The end of a timed window: a value fetch of the summed rewards; in a
    sharded run after one all_reduce of them over the ranks, so the window
    ends when the slowest rank is done."""
    if sharding is not None:
        rsum = rsum.clone()
        dist.all_reduce(rsum, group=sharding.group)
    float(rsum)


def _timed(fn, sharding=None) -> float:
    if sharding is not None:  # line the ranks up before the window starts
        _finish(torch.zeros((), device=sharding.device), sharding)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _need_cuda(what: str) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(f"the {what} measures the GPU and no CUDA device is available")
    return torch.device("cuda")


def graph_chunk(lp: _Loop, obs, state, draws, rsum: torch.Tensor):
    """One chunk of ``lp.chunk`` steps captured in a CUDA graph from static
    copies of (obs, state); returns ``replay(xs, c)``, which copies chunk
    ``c`` of the hoisted draws ``xs`` (``_draws``; ``draws`` gives the
    buffers' shapes) into the graph's buffers and replays it, carrying the
    state and adding the rewards into ``rsum``."""
    static = tree_map(torch.clone, (obs, state))
    chunk = tuple(torch.empty_like(x[:lp.chunk]) for x in draws)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the captured code path once
        for buf, src in zip(chunk, draws):
            buf.copy_(src[:lp.chunk])
        _steps(lp, *static, chunk, rsum)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _steps(lp, *static, chunk, rsum)
        tree_map(lambda dst, src: dst.copy_(src), static, out)

    def replay(xs, c: int) -> None:
        for buf, src in zip(chunk, xs):
            buf.copy_(src[c * lp.chunk:(c + 1) * lp.chunk])
        graph.replay()

    return replay


def _measure(lp: _Loop, num_steps: int, g: torch.Generator, sharding=None,
             eager: bool = True, graph: bool = True) -> tuple[float | None, float | None]:
    """Seconds of the eager and of the graph-replayed loop over
    ``num_steps`` steps (a multiple of ``lp.chunk``), None for a loop not
    asked for. With a ``sharding`` (``apx_torch.distrib``) every window
    starts on a collective that lines the ranks up and ends on one
    all_reduce (``_finish``)."""
    obs, state, _ = lp.venv.reset(lp.params, g)
    rsum = torch.zeros((), dtype=torch.float32, device=lp.params.device)

    # Eager: warmup, then the timed run.
    warm = _draws(lp, lp.chunk, g)
    obs, state = _steps(lp, obs, state, warm, rsum)
    draws = _draws(lp, num_steps, g)
    carry = {}

    def run_eager():
        carry["out"] = _steps(lp, obs, state, draws, rsum)
        _finish(rsum, sharding)

    eager_s = _timed(run_eager, sharding) if eager else None
    if not graph:
        return eager_s, None
    if eager:
        obs, state = carry["out"]

    replay_chunk = graph_chunk(lp, obs, state, draws, rsum)

    def replay(xs):
        for c in range(xs[0].shape[0] // lp.chunk):
            replay_chunk(xs, c)
        _finish(rsum, sharding)

    replay(warm)  # warmup replay
    graph_s = _timed(lambda: replay(draws), sharding)
    return eager_s, graph_s


def _card() -> dict:
    smi = nvidia_smi_line()
    return {"device_kind": torch.cuda.get_device_name(0),
            "power_limit_w": float(smi.rsplit(",", 1)[1].split()[0]), "nvidia_smi": smi}


def _rates(env: str, num_envs: int, num_steps: int, eager_s: float, graph_s: float) -> dict:
    steps = num_envs * num_steps
    return {
        f"{env}_env_steps_per_s": steps / graph_s,
        f"{env}_eager_env_steps_per_s": steps / eager_s,
        "graph_ms_per_step": 1e3 * graph_s / num_steps,
        "eager_ms_per_step": 1e3 * eager_s / num_steps,
    }


def _bench_next_step(env: str, num_envs: int, num_steps: int, seed: int) -> dict:
    dev = _need_cuda("bench")
    if num_steps % CHUNK:
        raise ValueError(f"num_steps must be a multiple of {CHUNK}")
    g = torch.Generator(device=dev).manual_seed(seed)
    eager_s, graph_s = _measure(_loop(env, num_envs, dev), num_steps, g)
    return {**_rates(env, num_envs, num_steps, eager_s, graph_s),
            "num_envs": num_envs, "num_steps": num_steps, **_card()}


def bench_lidar_rooms(num_envs: int = 4096, num_steps: int = 1024, seed: int = 0) -> dict:
    """Env-steps/s of the eager and the graph-captured LIDARLocRooms loop."""
    return _bench_next_step("lidar_rooms", num_envs, num_steps, seed)


def bench_lidar_rooms_window(num_envs: int = 4096, num_steps: int = 1024,
                             seed: int = 0) -> dict:
    """The same for LIDARLocRooms with ``raycast_backend="pallas_window"``
    (K2 windows); prints ``lidar_rooms_window_*`` keys."""
    return _bench_next_step("lidar_rooms_window", num_envs, num_steps, seed)


def bench_light_dark(num_envs: int = 4096, num_steps: int = 1024, seed: int = 0) -> dict:
    """Env-steps/s of the eager and the graph-captured LightDark loop (a
    bare LightDarkEnv under NEXT_STEP); prints ``light_dark_*`` keys."""
    return _bench_next_step("light_dark", num_envs, num_steps, seed)


def _reset_cost(lp: _Loop, g: torch.Generator) -> dict:
    """Milliseconds of one explicit reset (after a warmup reset) and the
    peak of ``max_memory_allocated`` over it, in bytes."""
    lp.venv.reset(lp.params, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_s = _timed(lambda: (lp.venv.reset(lp.params, g), torch.cuda.synchronize()))
    return {"reset_ms": 1e3 * reset_s, "reset_peak_bytes": torch.cuda.max_memory_allocated(),
            "reset_peak_above_start_bytes": torch.cuda.max_memory_allocated() - base}


def bench_lockstep(env: str, num_envs: int = 4096, num_steps: int = 1024, seed: int = 0) -> dict:
    """Env-steps/s of the eager and the graph-captured episodic loop of a
    LOCKSTEP workload, with the step count rounded down to whole cycles
    (at least one), the ms per step of the masked-merge ``venv.step``
    loop, and the explicit reset's ms and peak memory."""
    dev = _need_cuda("bench")
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = _loop(env, num_envs, dev)
    num_steps = max(lp.chunk, num_steps // lp.chunk * lp.chunk)
    reset = _reset_cost(lp, g)
    eager_s, graph_s = _measure(lp, num_steps, g)
    merge_eager_s, merge_graph_s = _measure(_loop(env, num_envs, dev, episodic=False),
                                            num_steps, g)
    corpus = {"tin_loc": "zh-plus/tiny-imagenet", "mnist": "mnist"}.get(env)
    bank = {"bank_build_s": BANK_BUILD_S[corpus]} if corpus else {}
    return {**_rates(env, num_envs, num_steps, eager_s, graph_s),
            "merge_graph_ms_per_step": 1e3 * merge_graph_s / num_steps,
            "merge_eager_ms_per_step": 1e3 * merge_eager_s / num_steps, **reset, **bank,
            "num_envs": num_envs, "num_steps": num_steps, **_card()}


# The ids the compat bench times, by workload name (apx's COMPAT_IDS).
COMPAT_IDS = {"lidar_rooms": "LIDARLocRooms-v0", "circle_square": "CircleSquare-v0"}
COMPAT_STEPS = 64


def _compat_actions(core, rng) -> dict:
    n, p = core.num_envs, core.params
    pred_shape = core.env.prediction_space(p).shape
    return {"action": rng.uniform(-1, 1, (n, *core.env.inner_action_space(p).shape))
            .astype(np.float32),
            "prediction": rng.normal(size=(n, *pred_shape)).astype(np.float32)}


def bench_compat(env: str, num_envs: int = 4096, num_steps: int = COMPAT_STEPS,
                 seed: int = 0) -> dict:
    """Env-steps/s through the drop-in adapter's core, and the median
    per-step breakdown: the action upload, the host time to issue the
    device step, the transfer (the wait for the step and the copy), the
    device ms of the step and of the copy (CUDA events), the bytes copied
    with the wire codec and without it, the host compose, the wire decode
    and the tracker."""
    from .compat import make_core

    dev = _need_cuda("compat bench")
    core = make_core(COMPAT_IDS[env], num_envs, device=dev, rng="native")
    rng = np.random.default_rng(seed)
    acts = [_compat_actions(core, rng) for _ in range(8)]
    core.reset(seed=seed)
    # The warmup crosses an episode boundary and takes one step past the
    # done: the NEXT_STEP reset-merge runs on the step after the done.
    done_seen = False
    warmup = 0
    for i in range(512):
        *_, term, trunc, _ = core.step(acts[i % 8])
        warmup += 1
        if done_seen:
            break
        done_seen = bool(np.any(term | trunc))
    core.reset(seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(num_steps):
        core.step(acts[i % 8])
    dt = time.perf_counter() - t0
    core.record_timings = True
    core.reset(seed=seed)
    for i in range(num_steps):
        core.step(acts[i % 8])
    rows = core.timings
    med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    breakdown = {
        "upload_ms": 1e3 * med["upload_s"], "issue_ms": 1e3 * med["issue_s"],
        "transfer_ms": 1e3 * med["transfer_s"], "compose_ms": 1e3 * med["compose_s"],
        "decode_ms": 1e3 * med["decode_s"], "tracker_ms": 1e3 * med["tracker_s"],
        "device_step_ms": med["device_step_ms"], "copy_ms": med["copy_ms"],
        "wire_bytes": int(med["bytes"]), "unencoded_bytes": int(med["unencoded_bytes"]),
        "host_ms_per_step": 1e3 * sum(med[k] for k in ("upload_s", "issue_s", "transfer_s",
                                                      "compose_s", "decode_s", "tracker_s")),
    }
    return {f"{env}_compat_env_steps_per_s": num_envs * num_steps / dt,
            "ms_per_step": 1e3 * dt / num_steps, "breakdown": breakdown,
            "warmup_steps": warmup, "num_envs": num_envs, "num_steps": num_steps,
            "env_id": COMPAT_IDS[env], **_card()}


def bench_sharded(env: str, sharding, num_envs: int = 4096, num_steps: int = 1024,
                  seed: int = 0) -> dict | None:
    """One rank of the sharded bench (JAX package: ``bench_env_multihost``):
    the eager and graph-chunk loops of ``env`` on this rank's block of
    ``num_envs`` envs, each window starting on a collective and ending on
    one all_reduce; then the slowest rank's seconds (an all_reduce MAX),
    and on rank 0 the plain one-process loops at all ``num_envs`` while the
    other ranks wait. Each rank seeds its own draws (``seed + rank``), so
    the blocks step distinct envs. Returns rank 0's line
    (``<env>_sharded_env_steps_per_s`` = num_envs x steps / the slowest
    rank's graph seconds, beside the plain loop's ``<env>_env_steps_per_s``
    from the same process), None on the other ranks."""
    dev = sharding.device
    if dev.type != "cuda":
        raise RuntimeError(f"the sharded bench measures GPUs; this rank's device is {dev}")
    block = sharding.block(num_envs)
    lp = _loop(env, block.stop - block.start, dev)
    if env in LOCKSTEP_WORKLOADS:
        num_steps = max(lp.chunk, num_steps // lp.chunk * lp.chunk)
    elif num_steps % CHUNK:
        raise ValueError(f"num_steps must be a multiple of {CHUNK}")
    g = torch.Generator(dev).manual_seed(seed + sharding.rank)
    eager_s, graph_s = _measure(lp, num_steps, g, sharding)
    slowest = torch.tensor([eager_s, graph_s], dtype=torch.float64, device=dev)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=sharding.group)
    plain = None
    if sharding.rank == 0:
        plain = _measure(_loop(env, num_envs, dev), num_steps,
                         torch.Generator(dev).manual_seed(seed))
    _finish(torch.zeros((), device=dev), sharding)  # the other ranks wait here
    if sharding.rank != 0:
        return None
    steps = num_envs * num_steps
    return {f"{env}_sharded_env_steps_per_s": steps / float(slowest[1]),
            f"{env}_sharded_eager_env_steps_per_s": steps / float(slowest[0]),
            "sharded_graph_ms_per_step": 1e3 * float(slowest[1]) / num_steps,
            "rank0_graph_ms_per_step": 1e3 * graph_s / num_steps,
            **_rates(env, num_envs, num_steps, *plain),
            "world_size": sharding.world_size, "backend": dist.get_backend(sharding.group),
            "device": str(dev), "num_envs": num_envs, "num_steps": num_steps, **_card()}



def bench_sharded_bank(env: str, sharding, num_envs: int = 4096, num_steps: int = 256,
                       seed: int = 0) -> dict | None:
    """One rank of the sharded-bank A/B: the eager loop of ``env`` on this
    rank's block with the bank replicated and with it sharded over the
    ranks (``shard_params(shard_leading=True)``, every bank fetch two
    all_reduces), interleaved replicated, sharded, sharded, replicated in
    these processes; the slowest rank's ms per step of each run and the
    bytes per step the sharded runs' fetches moved on this rank. A
    collective cannot be captured in a CUDA graph over gloo, so only the
    eager loop is timed. Returns rank 0's line, None on the other ranks."""
    from .distrib import COLLECTIVE_BYTES

    dev = sharding.device
    if dev.type != "cuda":
        raise RuntimeError(f"the sharded bench measures GPUs; this rank's device is {dev}")
    block = sharding.block(num_envs)
    loops = {name: _loop(env, block.stop - block.start, dev, overrides={"shard_bank": sharded},
                         sharding=sharding)
             for name, sharded in (("replicated", False), ("sharded", True))}
    lp = loops["replicated"]
    if env in LOCKSTEP_WORKLOADS:
        num_steps = max(lp.chunk, num_steps // lp.chunk * lp.chunk)
    elif num_steps % CHUNK:
        raise ValueError(f"num_steps must be a multiple of {CHUNK}")
    ms = {name: [] for name in loops}
    moved = {}
    for i, name in enumerate(("replicated", "sharded", "sharded", "replicated")):
        g = torch.Generator(dev).manual_seed(seed + sharding.rank)
        before = COLLECTIVE_BYTES["bank_fetch"]
        eager_s, _ = _measure(loops[name], num_steps, g, sharding, graph=False)
        slowest = torch.tensor([eager_s], dtype=torch.float64, device=dev)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=sharding.group)
        ms[name].append(1e3 * float(slowest[0]) / num_steps)
        if name == "sharded":
            # _measure steps a warmup chunk and the timed run from one reset
            moved[i] = (COLLECTIVE_BYTES["bank_fetch"] - before) / (num_steps + lp.chunk)
    if sharding.rank != 0:
        return None
    bank = (getattr(loops["sharded"].params, "map_bank", None)
            or loops["sharded"].params.dataset)
    return {"env": env, "eager_ms_per_step": ms, "bank_fetch_bytes_per_step_rank0":
            sorted(moved.values()), "bank_rows_per_rank": bank.shard.hi - bank.shard.lo,
            "bank_rows": bank.shard.num_rows, "world_size": sharding.world_size,
            "backend": dist.get_backend(sharding.group), "device": str(dev),
            "num_envs": num_envs, "num_steps": num_steps, **_card()}


# The A/B switches the bench takes: command-line dest -> the env param it sets.
AB_SWITCHES = {"raycast_backend": "raycast_backend", "beam_tables": "use_beam_tables",
               "beam_rects": "beam_rects", "image_storage": "image_storage",
               "glimpse_window": "glimpse_window", "sampler": "unique_sampling_backend"}


def bench_ab(env: str, overrides: dict, num_envs: int = 4096, num_steps: int = 1024,
             seed: int = 0, reset: bool = False) -> dict:
    """A/B of one switch (``overrides``, env params) against the workload's
    default, in one process, interleaved default, variant, variant,
    default: the graph loop's ms per step of each run (PERF.md: graph
    loops sit at levels ~18% apart between processes, so only pairs in one
    process count). With ``reset`` (the sampler), the explicit reset's ms
    and peak memory of each run instead, each measured after a warmup
    reset of its own."""
    dev = _need_cuda("bench")
    loops = {"default": _loop(env, num_envs, dev), "variant": _loop(env, num_envs, dev,
                                                                    overrides=overrides)}
    lp = loops["default"]
    if env in LOCKSTEP_WORKLOADS:
        num_steps = max(lp.chunk, num_steps // lp.chunk * lp.chunk)
    elif num_steps % CHUNK:
        raise ValueError(f"num_steps must be a multiple of {CHUNK}")
    runs = {name: [] for name in loops}
    for name in ("default", "variant", "variant", "default"):
        g = torch.Generator(device=dev).manual_seed(seed)
        if reset:
            runs[name].append(_reset_cost(loops[name], g))
        else:
            _, graph_s = _measure(loops[name], num_steps, g, eager=False)
            runs[name].append(1e3 * graph_s / num_steps)
    key = "reset" if reset else "graph_ms_per_step"
    out = {"env": env, "switch": overrides, f"default_{key}": runs["default"],
           f"variant_{key}": runs["variant"], "num_envs": num_envs, **_card()}
    if not reset:
        out["variant_over_default"] = sum(runs["variant"]) / sum(runs["default"])
        out["num_steps"] = num_steps
    return out


def profile(env: str = "lidar_rooms", num_envs: int = 4096, seed: int = 0, top: int = 12,
            trace_path: str | None = None, overrides: dict | None = None) -> dict:
    """Device time per step of the eager loop by kernel, from a
    ``torch.profiler`` trace of PROFILE_STEPS steps (two CircleSquare
    cycles) after a warmup. With ``trace_path`` the trace is also written
    there as chrome JSON (``apx_torch.tools.parse_trace`` reads it)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    dev = _need_cuda("profile")
    lp = _loop(env, num_envs, dev, overrides=overrides)
    g = torch.Generator(device=dev).manual_seed(seed)
    obs, state, _ = lp.venv.reset(lp.params, g)
    rsum = torch.zeros((), dtype=torch.float32, device=dev)
    obs, state = _steps(lp, obs, state, _draws(lp, lp.chunk, g), rsum)
    draws = _draws(lp, PROFILE_STEPS, g)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _steps(lp, obs, state, draws, rsum)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    per_step = 1e3 * PROFILE_STEPS
    # The exact-rounding emulation (core.numerics) is the step's float64
    # work: its kernels are the ones instantiated for double.
    f64 = [e for e in kernels if "double" in e.key]
    return {
        "workload": WORKLOADS[env][0],
        "overrides": overrides or {},
        "steps": PROFILE_STEPS,
        "wall_ms_per_step": 1e3 * wall / PROFILE_STEPS,
        "device_busy_ms_per_step": total_us / per_step,
        "device_idle_share": max(0.0, 1.0 - total_us / 1e6 / wall),
        "kernel_launches_per_step": sum(e.count for e in kernels) / PROFILE_STEPS,
        "float64_ms_per_step": sum(e.self_device_time_total for e in f64) / per_step,
        "float64_launches_per_step": sum(e.count for e in f64) / PROFILE_STEPS,
        "port_kernels_ms_per_step": {
            name: sum(e.self_device_time_total for e in kernels if key in e.key) / per_step
            for name, key in PORT_KERNELS.items()},
        "top": [{"kernel": e.key[:90], "ms_per_step": e.self_device_time_total / per_step,
                 "calls_per_step": e.count / PROFILE_STEPS} for e in kernels[:top]],
        "trace": trace_path,
        **_card(),
    }


def profile_graph(env: str = "lidar_rooms", num_envs: int = 4096, seed: int = 0,
                  trace_path: str | None = None) -> dict:
    """``torch.profiler`` over PROFILE_CHUNKS replays of the captured graph
    chunk (``graph_chunk``), after a warmup replay outside the profiler
    and one under it that the profiler's schedule drops, written to
    ``trace_path`` as chrome JSON when given; what CUPTI recorded inside
    the graph is read from the trace (``apx_torch.tools.parse_trace``).
    Returns the steps traced, the wall milliseconds per step of the traced
    replays and of as many replays with the profiler off (CUPTI's tracing
    of a graph launch costs milliseconds of host time, so the idle share
    is read against the latter)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, schedule

    dev = _need_cuda("profile")
    lp = _loop(env, num_envs, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    obs, state, _ = lp.venv.reset(lp.params, g)
    rsum = torch.zeros((), dtype=torch.float32, device=dev)
    draws = _draws(lp, lp.chunk * (PROFILE_CHUNKS + 2), g)
    replay = graph_chunk(lp, obs, state, draws, rsum)

    def replays() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(2, PROFILE_CHUNKS + 2):
            replay(draws, c)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    replay(draws, 0)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        replay(draws, 1)
        torch.cuda.synchronize()
        prof.step()
        wall = replays()
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    plain = replays()
    steps = PROFILE_CHUNKS * lp.chunk
    return {"workload": WORKLOADS[env][0], "steps": steps, "chunk": lp.chunk,
            "wall_ms_per_step": 1e3 * wall / steps,
            "unprofiled_wall_ms_per_step": 1e3 * plain / steps, "trace": trace_path,
            **_card()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", choices=sorted(WORKLOADS), default="lidar_rooms")
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--num-steps", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="with --profile: write the eager trace (eager.json) and a trace "
                         "of four replays of the graph chunk (graph.json) to DIR")
    ap.add_argument("--compat", action="store_true",
                    help="time the drop-in adapter (--env lidar_rooms or circle_square)")
    ap.add_argument("--distributed", action="store_true",
                    help="one rank of the sharded bench, under torchrun")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--raycast-backend", default=None,
                    help="A/B a LIDAR raycast backend against the default")
    ap.add_argument("--beam-tables", action="store_true",
                    help="A/B the beam-table scan (LIDAR)")
    ap.add_argument("--beam-rects", default=None, choices=("on", "off", "auto"),
                    help="A/B per-beam rectangles (with --raycast-backend bitslab2d)")
    ap.add_argument("--image-storage", default=None,
                    choices=("array", "packed", "flat", "gather"))
    ap.add_argument("--glimpse-window", default=None, choices=("off", "rows"))
    ap.add_argument("--sampler", default=None, choices=("cartesian", "chunked", "streamed"),
                    help="A/B the unique-target sampler's explicit reset (tin_loc)")
    ap.add_argument("--shard-bank", action="store_true",
                    help="with --distributed: A/B the bank sharded against replicated")
    args = ap.parse_args(argv)
    switch = {param: getattr(args, dest) for dest, param in AB_SWITCHES.items()
              if getattr(args, dest) not in (None, False)}
    if args.distributed:
        from .distrib import init_distributed, make_env_mesh

        init_distributed(backend=args.backend, device=args.device)
        try:
            fn = bench_sharded_bank if args.shard_bank else bench_sharded
            res = fn(args.env, make_env_mesh(args.device), args.num_envs, args.num_steps,
                     args.seed)
        finally:
            dist.destroy_process_group()
        if res is not None:
            print(json.dumps(res))
    elif switch and not args.profile:
        print(json.dumps(bench_ab(args.env, switch, args.num_envs, args.num_steps, args.seed,
                                  reset="unique_sampling_backend" in switch)))
    elif args.compat:
        res = bench_compat(args.env, args.num_envs, COMPAT_STEPS, args.seed)
        print(f"breakdown: {json.dumps(res.pop('breakdown'))}")
        print(json.dumps(res))
    elif args.profile:
        trace = None if args.trace is None else os.path.join(args.trace, "eager.json")
        if args.trace is not None:
            os.makedirs(args.trace, exist_ok=True)
        print(json.dumps(profile(args.env, args.num_envs, args.seed, trace_path=trace,
                                 overrides=switch or None)))
        if args.trace is not None:
            print(json.dumps(profile_graph(args.env, args.num_envs, args.seed,
                                           trace_path=os.path.join(args.trace, "graph.json"))))
    elif args.env in LOCKSTEP_WORKLOADS:
        print(json.dumps(bench_lockstep(args.env, args.num_envs, args.num_steps, args.seed)))
    else:
        print(json.dumps(_bench_next_step(args.env, args.num_envs, args.num_steps, args.seed)))


if __name__ == "__main__":
    main()
