"""The rollout mix: a vector env of N envs stepped on the card by a random
policy, as apx's users run a jitted scan, its chunks captured as CUDA
graphs and replayed.

The loop is the port's bench loop (``apx_torch/bench.py`` ``_steps``,
``graph_chunk``), copied: apx's random policy (actions uniform in [-1, 1],
standard-normal predictions, one element of every observation leaf folded
into the next action times 1e-12, so that each step depends on the last),
the draws of every step injected, so a captured graph holds no generator.
The family's ``step_chunk`` steps a chunk (which entry each step calls is
the family's) and adds its rewards and terminations into per-env
accumulators on the card. The draws come from a pool made on the card from
the seed at set-up (``pool_chunks`` chunks), chunk ``c`` of the window
reading slot ``c`` mod the pool.

Set-up, from the process's start: the family's data and env, the pool,
the explicit reset (with whatever steps the family takes after it), the
capture and ``warm_seconds`` of warm replays. The window then replays
chunks until ``--seconds`` have passed on the host's clock and ends on a
synchronise: ``env_steps_per_s`` is all the env steps of the window over
its seconds. Two chunks drawn from the seed (in the window's first
``check_range`` chunks) have their outputs, and the state before them,
copied aside; after the window the reference judges them. Where the
family's explicit reset comes from draws, the reference also judges that
reset and the first warm chunk after it from the draws alone.

The chunks issued in each 2 s of the window are logged; where they show
two rates (bins more than ``TWO_RATES`` apart), the run says so on
standard error: a freshly captured graph can replay slower for a while
(PERF.md), and such a run reads off the others.

With ``--trace 1`` a stretch of ``trace_chunks`` chunks after the window
is profiled, and replayed again unprofiled for its wall time; the
per-layer metrics read that trace.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
from apx_torch.core.env import tree_map

from ..yardstick import judge, trace as tr

__all__ = ["run", "policy", "probe", "rates", "TWO_RATES"]

# Bins of chunks per 2 s this far apart, as a share of the fastest, are two rates.
TWO_RATES = 0.03


def probe(obs: dict) -> torch.Tensor:
    """One element of every observation leaf (keys in sorted order) as
    float32, summed."""
    return sum(obs[k].reshape(-1)[0].to(torch.float32) for k in sorted(obs))


def policy(action: torch.Tensor, obs: dict) -> torch.Tensor:
    """The step's action: the drawn action plus the observation probe times
    1e-12, clipped to [-1, 1] (float32)."""
    return (action + probe(obs) * 1e-12).clamp(-1.0, 1.0)


def _slot(pool: dict, c: int, chunk: int, slots: int) -> dict:
    s = (c % slots) * chunk
    return {k: v[s:s + chunk] for k, v in pool.items()}


class _Graph:
    """The chunk ``step(obs, state, draws) -> (obs, state)`` captured as one
    CUDA graph over static copies of (obs, state), as the port's bench
    captures it; ``replay(draws)`` copies the chunk's draws into the
    graph's buffers and replays it."""

    def __init__(self, step, obs, state, draws: dict):
        self.static = tree_map(torch.clone, (obs, state))
        self.bufs = {k: torch.empty_like(v) for k, v in draws.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm the captured code path once
            _copy_into(self.bufs, draws)
            step(*self.static, self.bufs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _copy_tree(self.static, step(*self.static, self.bufs))

    def replay(self, draws: dict) -> None:
        _copy_into(self.bufs, draws)
        self.graph.replay()


def _copy_tree(dst, src) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _copy_into(bufs: dict, leaves: dict) -> None:
    for k, v in leaves.items():
        bufs[k].copy_(v)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def rates(marks: list[float], width: float = 2.0) -> tuple[list[int], bool]:
    """The chunks issued in each ``width`` seconds of the window (the
    host's issue times ``marks``), and whether they show two rates. The
    first bin, which also fills the launch queue, and the last, partial
    one are not compared."""
    counts = np.bincount((np.asarray(marks) // width).astype(int)).tolist()
    whole = counts[1:-1]
    two = len(whole) >= 2 and (max(whole) - min(whole)) > TWO_RATES * max(whole)
    return counts, two


def run(cell: dict, seed: int, seconds: float, traced: bool, t0: float, log,
        dev: torch.device, control=None, runner=None) -> dict:
    """One run of a rollout cell on ``dev``: returns the end-to-end
    readings, the per-layer context (traced runs), the check's numbers and
    what the device showed. ``runner(step, obs, state, draws)`` makes the
    chunk's replayer (``_Graph``; the CPU tests step it eagerly). With
    ``control`` (a dtype) the reference computed in that precision is also
    judged in the program's place (``benchmark/control.py``)."""
    fam, config, traffic = cell["family"], cell["config"], cell["traffic"]
    runner = runner or _Graph

    def phase(name: str) -> None:
        _sync(dev)
        log(f"set-up: {name} by {time.perf_counter() - t0:.3f} s")

    phase("start")
    gen = torch.Generator(dev).manual_seed(seed)
    env = fam.build(config, traffic, seed, dev)
    phase("data and env")
    slots = traffic["pool_chunks"]
    pool = fam.draw_pool(env, gen, slots * env.chunk)
    phase("draw pool")
    obs, state, init_draws = fam.initial_reset(env, gen, policy)
    phase("explicit reset")
    init_leaves = None if init_draws is None else tree_map(
        torch.clone, fam.program_leaves(obs, state))
    n = env.num_envs
    racc = torch.zeros(n, dtype=torch.float32, device=dev)
    dacc = torch.zeros(n, dtype=torch.int32, device=dev)
    graph = runner(lambda o, s, d: fam.step_chunk(env, o, s, d, racc, dacc, policy),
                   obs, state, _slot(pool, 0, env.chunk, slots))
    del obs, state
    phase("capture")
    rng = np.random.default_rng(seed)
    checked = sorted(int(c) for c in rng.choice(np.arange(1, traffic["check_range"]), 2,
                                                replace=False))
    leaves = fam.program_leaves(*graph.static)
    leaves.update(reward_sum=racc, term_count=dacc)

    def blank() -> dict:
        return {k: torch.empty_like(v) for k, v in leaves.items()}

    after = {c: blank() for c in checked}
    before = {c: blank() for c in checked}
    first = None if init_leaves is None else blank()
    # Warm replays for ``warm_seconds``: the card replays a freshly captured
    # graph slower for the first seconds (PERF.md), which belongs to set-up.
    # The first of them starts from the explicit reset: its outputs are kept.
    racc.zero_()
    dacc.zero_()
    done = 0
    t_warm = time.perf_counter()
    while done < 2 or time.perf_counter() - t_warm < traffic["warm_seconds"]:
        graph.replay(_slot(pool, done, env.chunk, slots))
        if done == 0 and first is not None:
            _copy_into(first, leaves)
        done += 1
    for c in checked:
        _copy_into(before[c], leaves)
        _copy_into(after[c], leaves)
    racc.zero_()
    dacc.zero_()
    _sync(dev)
    setup_s = time.perf_counter() - t0

    c = 0
    t_start = time.perf_counter()
    marks = []
    while True:
        snap = c in after
        if snap:
            _copy_into(before[c], leaves)
            racc.zero_()
            dacc.zero_()
        graph.replay(_slot(pool, c, env.chunk, slots))  # chunk c reads slot c mod the pool
        if snap:
            _copy_into(after[c], leaves)
        c += 1
        now = time.perf_counter() - t_start
        marks.append(now)
        if now >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t_start
    chunks = c
    per_2s, two_rates = rates(marks)
    log(f"window: chunks issued per 2 s {per_2s}; {done} warm chunks")
    steps = chunks * env.chunk
    memory_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    per_layer = None
    if traced:
        per_layer = _trace(graph, pool, chunks, env, slots, traffic["trace_chunks"])
    del graph, leaves
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The check, once the window has closed and the program's state is freed.
    t_check = time.perf_counter()
    missing = [c for c in checked if c >= chunks]
    tol = cell["check"]["tol"]
    tally = {"program": [0, 0], "control": [0, 0]}
    report, record = {}, {}

    def judge_one(name: str, program: dict, reference: dict, low) -> None:
        bad, report[name] = judge.departures(program, reference, tol)
        tally["program"][0] += int(bad.sum())
        tally["program"][1] += bad.numel()
        if low is not None:
            bad, _ = judge.departures(low(), reference, tol)
            tally["control"][0] += int(bad.sum())
            tally["control"][1] += bad.numel()

    if init_leaves is not None:
        reset_ref = fam.reference_reset(env, init_draws, torch.float64)
        judge_one("reset", init_leaves, reset_ref,
                  None if control is None else
                  lambda: fam.reference_reset(env, init_draws, control))
        slot0 = _slot(pool, 0, env.chunk, slots)
        judge_one("warm chunk 0 from the reset", first,
                  fam.reference_chunk(env, reset_ref, slot0, None, torch.float64, policy),
                  None if control is None else lambda: fam.reference_chunk(
                      env, fam.reference_reset(env, init_draws, control), slot0, None,
                      control, policy))
        del reset_ref
    for c in checked:
        if c >= chunks:
            continue
        args = (env, before[c], _slot(pool, c, env.chunk, slots),
                _slot(pool, c - 1, env.chunk, slots))
        ref = fam.reference_chunk(*args, torch.float64, policy, record if not record else None)
        judge_one(f"chunk {c}", after[c], ref, None if control is None else
                  lambda: fam.reference_chunk(*args, control, policy))
    _sync(dev)
    check_s = time.perf_counter() - t_check
    for name, rep in report.items():
        log(f"check {name}: " + ", ".join(
            f"{k} {v['departing']}" + ("" if v["widest"] is None else f" (widest {v['widest']:.3g})")
            for k, v in rep.items()))
    if two_rates:
        log(f"window: two rates: chunks per 2 s from {min(per_2s[1:-1])} to {max(per_2s[1:-1])}; "
            "a freshly captured graph's slow state in the window (PERF.md)")
    if per_layer is not None:
        per_layer["least_s"] = fam.least_seconds(env, record)
    shares = {k: v[0] / v[1] if v[1] else 1.0 for k, v in tally.items()}
    return {
        "e2e": {"env_steps_per_s": steps * n / window_s, "setup_s": setup_s},
        "attempted": steps * n,
        "failed": 0,
        "memory_peak_bytes": memory_peak,
        "compared": {"departing_share": shares["program"]},
        "control": {"departing_share": shares["control"]} if control is not None else None,
        "problems": [f"checked chunk {c} not reached: the window ran {chunks} chunks"
                     for c in missing],
        "per_layer": per_layer,
        "window": {"seconds": window_s, "chunks": chunks, "steps": steps, "checked": checked,
                   "check_s": check_s, "two_rates": two_rates},
    }


def _trace(graph: _Graph, pool: dict, start: int, env, slots: int, count: int) -> dict:
    """Profile ``count`` chunks (after a warm run of them outside the
    profiler and one inside that its schedule drops), then time them again
    unprofiled: the trace, its steps and both wall times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def run() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(count):
            graph.replay(_slot(pool, start + i, env.chunk, slots))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        prof.step()
        traced_wall = run()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        trace = tr.load(path)
    plain_wall = run()
    return {"trace": trace, "steps": count * env.chunk, "traced_wall_s": traced_wall,
            "wall_s": plain_wall}
