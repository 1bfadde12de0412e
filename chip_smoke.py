"""Chip smoke test of the PyTorch / CUDA port (apx_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: compiles the CUDA kernels from apx_torch/csrc for sm_90a.
3. kernels: K1 (``raycast_fast`` at R = 1, 2, 8 and ``raycast_typed`` at
   R = 8 from cell centres, where corner grazes occur) against its plain
   PyTorch form on the card, bitwise, at N = 4096 on rooms maps; K3
   (``glimpse``) against its plain form within 1e-6 (TF32 off) at
   CircleSquare's geometry (float32 bank, 28x28x1, 5x5 sensor) and, on
   random uint8 bytes, TinyImageNet's (64x64x3, 10x10 sensor), MNIST's
   (28x28x1, 5x5) and CIFAR10's (32x32x3, 5x5), N = 4096, positions
   including the +-1 corners and edges. K1 also bitwise on
   ``edge_casts`` (rooms 32x32, maze 21x21, random 24x16, 7x5 and 1x1
   maps; R = 1, 2, 3, 8, 33; N = 1003). Device time per launch
   of each (CUDA graph replay, CUDA events), of its plain form, of
   ``grid_sample`` for K3 (the library yardstick; the port never calls
   it), and the bound.
3a. lidar step kernels: F1's four stages (``ops.lidar_step_cuda``) and F2
   (``ops.merge_cuda``) against their plain forms on the card, bitwise
   with NaN as NaN (``phase_lidar_step_kernels``): F1 on
   ``lidar_step_cases`` at N = 4096, F2 on a step of LIDARLocRooms-v0,
   LIDARLocMaze-v0 and LightDark-v0 with half the envs reset, and F2's
   prediction gradient; one dense LIDAR step launches S 1, R 1, F2 1 and
   no standalone K1, F1 or N1-N3 (``DENSE_STEP``); then S and R
   (``ops.lidar_fused_cuda``) against their plain forms
   (``ops.lidar_fused``) at N = 4096 on the rooms (32x32) and maze (21x21)
   banks, R typed and untyped, S from edge actions and positions
   (``fused_inputs``); device, plain and bound ms of each.
3b. light dark kernel: L's step and reset (``ops.light_dark_cuda``)
   against their plain forms (``envs.light_dark.step_plain`` and
   ``noisy_position``) on the card at N = 4096 and 16384, bitwise with NaN
   as NaN, on ``light_dark_cases`` (zero, unit and NaN actions, moves onto
   |p| = 1, the light, noise past +-2); device, plain and bytes-bound ms
   of each entry at each N (``phase_light_dark_kernel``). Phases 4 and 9
   check the launches per step (``lidar_path_launches``), N1 once (the
   reset's time obs); every LIDAR path without a metrics wrapper launches
   no N3.
4. LIDAR main path: ``apx_torch.make_vec("LIDARLocRooms-v0",
   num_envs=4096)``, reset and 250 steps of uniform random actions with
   zero predictions; every obs finite, lidar in [0, 1], rewards in
   [-2.9, 0.1], every env through at least two episode ends, and S once
   per step, R once at the reset and once per step, F2 once per step, no
   standalone K1 or F1 (``lidar_path_launches``).
5. LIDAR card vs CPU: one 120-step trajectory at N = 256 with injected
   reset draws on the card (kernels) and on the CPU (plain forms); obs,
   states, rewards and dones bitwise equal.
6. CircleSquare main path: ``apx_torch.make_vec("CircleSquare-v0",
   num_envs=4096)`` under LOCKSTEP, reset and 51 steps (three 17-step
   cycles) of uniform random actions with zero logits; every obs finite,
   glimpse in [0, 1], rewards in [-1.0015, -1 + 1e-6] (normalized CE of
   zero logits is 1, base reward -1e-3 |a|), every env through at least
   two LOCKSTEP resets, and ``glimpse`` launched once for the reset and
   twice per masked-merge step.
7. CircleSquare card vs CPU (CircleSquare-v0 and CircleSquareInverted-v0):
   51 steps at N = 256 with injected reset draws; states, dones and the
   non-glimpse obs bitwise equal, glimpse and rewards within 1e-6.
8. window kernels: K2 (``extract_windows``, which cuts the window of the
   ray-padded map from the unpadded one) against its plain form on the
   card, bitwise, at N = 4096 rooms maps with starts from
   ``window_starts`` of positions spread over [0, 32]^2 (corners and edges
   first), again on a copy of those maps that starts one byte past a word
   (the kernel's byte loads, timed beside its word loads), and against
   slicing the padded copy (``pad_occupancy``; also the library yardstick, one
   advanced-indexing call on ``unfold`` views, which the port never
   calls); then on 1024 rooms and 1024 maze (21x21) maps with starts drawn
   outside the env path's range (negative and past the end), so the clamp
   runs on the card. K1 on K2's (24, 16) windows in the window frame (the
   casts of phase 3, cut to their windows), bitwise; device time, plain
   time and bound of each.
9. window main path: ``apx_torch.make_vec("LIDARLocRooms-v0",
   num_envs=4096, raycast_backend="pallas_window")``, reset and 250 steps
   as in phase 4, with the same checks; per masked-merge step K2 is
   launched twice (step and reset), ``raycast_fast`` three times,
   ``raycast_typed`` once per reset and F1 four times; no S or R.
10. window card vs CPU: phase 5 with the window backend.
11. K4 (``chain_cuda``): wide and narrow layouts bitwise equal to the
    plain ``chain_body`` at iters = 1, 5, 7 and 512 (below, at and past
    the unroll factor), at odd row counts (4095 wide, 511 narrow) and at
    ``measure()``'s sizes; then the study's entry point ``measure()`` at
    apx's sizes (rows = 4096, iters = 512, 20 reps), its line printed, and
    the plain chain's device time at each layout.
12. LightDark main path: ``apx_torch.make_vec("LightDark-v0",
    num_envs=4096)``, reset and 200 steps of uniform random actions with
    zero predictions (its step draws its observation noise); every obs
    finite, ``noisy_position`` in [-2, 2], ``time_step`` in [-1, 1], rewards
    in [-2.002, 1] (base reward 1 - 1e-3 |a|^2 less a normalized MSE of at
    most 3), every env through at least three episode ends; L's step once
    per step, L's reset once at the reset and once per step, F2 once per
    step, and no N2 or N3.
13. wrapped kernel paths: ``make_vec("LIDARLocRooms-sparse-v0",
    num_envs=4096, metrics=True)`` for 250 steps and
    ``make_vec("CircleSquare-sparse-v0", num_envs=4096, metrics=True)`` for
    51, with zero predictions. S's and R's launches are phase 4's (1 per
    step, 1 + steps; no F2: the ``-sparse`` loss takes the plain merge),
    K3's phase 6's (1 + 2 steps). The weight equals terminated (on a
    NEXT_STEP autoreset step it is the masked-out step's, as in apx); the
    reward equals the base reward, bitwise, wherever the weight is 0 or the
    env was reset, and base_reward - weight * dense loss within 1e-6
    elsewhere; the float
    stats are finite exactly where done; at done ``vector_lengths`` equals
    the episode's steps (the TimeLimit count: 100 for a LIDAR episode that
    ends on time, 16 for CircleSquare); CircleSquare's
    ``avg_correct_label_prob`` is 0.5 within 1e-6.
14. card vs CPU with step draws: phase 5 for ``LightDark-v0`` (N = 256,
    120 steps, step draws drawn on the CPU and injected), bitwise; and for
    ``LIDARLocRooms-sparse-v0`` and ``CircleSquare-sparse-v0`` with
    ``metrics=True``, at their base ids' tolerances, ``info["stats"]`` and
    the metrics buffers too (ints, bools and NaN positions bitwise, floats
    within 1e-6).
15. TinyImageNetLoc main path: ``apx_torch.make_vec("TinyImageNetLoc-v0",
    num_envs=4096)`` over the registry's synthetic bank (its kind
    printed): the explicit reset, which runs the unique-target sweep
    (cuBLAS, TF32 off), timed with its peak ``max_memory_allocated``; then
    51 steps (three 17-step LOCKSTEP cycles) of uniform actions with zero
    predictions. Every obs finite, glimpse and target glimpse in [0, 1],
    rewards in [-3.0015, 0] (base -1e-3 |a| less a normalized MSE of at
    most 3), every env through at least two LOCKSTEP resets; ``glimpse``
    launched twice by the reset (obs and target) and three times per
    masked-merge step (the step's obs, the autoreset's obs and target).
16. card vs CPU, the new ids: the sweep of ``TinyImageNetLoc-v0`` at
    N = 64 from the same draws (scores within 3e-6; top-k and targets
    equal on every env whose ranking the scores decide, their count
    printed); its trajectory, 51 steps from the CPU's reset state (targets,
    ints and bools bitwise, glimpses, target glimpses and rewards within
    1e-6); ``DoubleCircleSquare-v0``, ``MNIST-v0``, ``CIFAR10-v0``,
    ``CircleSquareHideAndSeek-v0`` and
    ``CircleSquareHideAndSeekNoPrediction-sparse-v0`` at N = 256 for 51
    steps at CircleSquare's tolerances, ``glimpse`` launched 1 + 2 per
    step on the card.
17. apx's bench: ``LIDARLocMaze-v0`` and ``LIDARLocRoomsStatic-v0`` card vs
    CPU (phase 5's check, N = 256, 120 steps, bitwise); ``python -m
    apx_torch.bench --deep --emit FILE`` in a subprocess: the ten workloads
    at N = 4096 for 1024 steps (eager and CUDA graph, the banks at apx's
    default size), ``lidar_rooms``, ``mnist`` and ``tin_loc`` at N = 16384,
    the compat rows and the calibration number; no record with an error,
    every value positive, apx's roofline stats on every device record, the
    fingerprint's platform ``gpu``. Then the bench's loop (``_loop``,
    ``_steps``) of ``lidar_maze``, ``lidar_rooms_static`` and ``cifar10`` at
    N = 4096 and of ``lidar_rooms``, ``mnist`` and ``tin_loc`` at N = 16384,
    one graph chunk from the explicit reset each: S's, R's and K3's
    launches equal to the wrappers' calls and to
    ``expected_workload_launches``, and each kernel held on the first
    inputs the path gave it (S and R bitwise, K3 within 1e-6), with its
    device, plain and bound ms.
18. sharded LIDAR, world 1 over nccl: ``python -m
    apx_torch.distrib.selftest`` (one process, a FileStore,
    ``NCCL_SOCKET_IFNAME=lo``), ``sharded_rollout`` of
    ``LIDARLocRooms-v0`` at N = 4096 for 250 steps: the final state
    bitwise the one-process ``rollout`` on the card with the same seed, done
    counts equal, mean rewards within rtol 1e-6, S launched once per step
    and R once per step and once at the reset, in both runs, and N1 in
    each run's report (which lists every kernel, ``ops._launch.launches``).
19. two gloo ranks on cuda:0 (NCCL refuses two ranks on one GPU), N = 4096
    in all: LIDARLocRooms-v0 for 250 steps and the episodic CircleSquare-v0
    (period 16) for 51, each rank's block bitwise the solo run's block,
    the same counts and tolerance, K3 launched once per step and once at
    the reset on each rank, N1 in every report.
20. checkpoint: LIDARLocRooms-v0 and CircleSquare-v0 with ``metrics=True``
    at N = 4096, saved after k steps with the generator's state, restored
    into a fresh state on the card and continued: bitwise the uninterrupted
    run; the card checkpoint restored onto a CPU ``like`` and back, bitwise.
21. BankRotator with two 1.23 GB uint8 slabs (TinyImageNet's banked
    size): each swap bitwise its host slab; the H2D rate alone and while the
    ``tin_loc`` graph loop runs, and that loop's ms per step before the
    rotator, and in the chunks wholly inside and wholly outside the copy
    (CUDA events on one timeline).
22. native banks: the C++ generator built on this machine, rooms and maze
    banks on the card equal to the CPU's, ``fetch_halves`` bitwise.
23. sharded throughput: ``torchrun --standalone -m apx_torch.bench
    --distributed`` for ``lidar_rooms`` and ``circle_square``, one rank over
    nccl and two gloo ranks on cuda:0 (rank 0's line: the sharded rate
    beside the plain loop's, measured in the same process).

24. compat, card against CPU: the drop-in adapter's gymnasium-free core
    (``apx_torch.compat.make_core``, what ``make_vec`` wraps) in
    ``rng="reference"`` mode, seed 0, on the card and on the CPU from the
    same numpy actions (uniform) and predictions (uniform, normal logits):
    ``LIDARLocRooms-v0`` at N = 64 for 210 steps (two 100-step TimeLimit
    boundaries and their NEXT_STEP resets on host-generated maps), the same
    with ``raycast_backend="pallas_window"``, ``LightDark-v0`` at N = 64 for
    210 steps, all bitwise (obs through the wire codec, reward, dones, info
    and every dtype); ``CircleSquare-v0`` at N = 64 for 40 steps (two
    LOCKSTEP boundaries) and ``TinyImageNetLoc-v0`` at N = 4 (the reset's
    host sweep and 10 steps): ints and bools bitwise, floats within 1e-6.
    The log stats of the gymnasium-free aggregation (``compat.stats``) are
    compared the same way. K1, K2, K3, F1 and S launches on the card's
    run, the counts set to 0 just before each path: ``raycast_typed`` 1 at
    the reset and 1 per NEXT_STEP merge step (a step that follows a done;
    the reference mode builds those states from host maps and scans them
    with K1, not R), S 1 per step (dense), or ``raycast_fast`` 3 and F1 4
    per step and K2 ``window`` 1 per step plus those (window), ``glimpse`` 1
    per step plus 1 at the reset (CircleSquare) and 2 at the reset
    (TinyImageNetLoc: obs and target).
25. compat throughput: ``apx_torch.bench.bench_compat`` for ``lidar_rooms``
    and ``circle_square`` at N = 4096 (``rng="native"``, 64 timed steps),
    with the per-step breakdown and the bytes copied per step with the wire
    codec and without it. The gymnasium shells and the PIL frames need
    gymnasium and pillow, which the card's machine lacks; the CPU tests
    cover them (one line says so).
26. perception module, card against CPU: the reference's
    ``ImagePerceptionModule`` (``apx_torch.compat.perception_module``) over
    the host ``CircleSquareDataset`` (28x28, 5x5 sensor) at N = 4096 on the
    card and on the CPU from one seed: reset and 32 steps of seeded numpy
    actions and qualities, observations, rewards, dones, infos, labels and
    positions bitwise; then ``sample_unique_glimpse_positions`` on the card
    (N = 4096) against the CPU's scores and positions of PM_UNIQUE_CPU_ENVS
    envs spread over the batch (every 64th, so every block of the card's
    sweep has one) from the same draws: scores bitwise (the count
    of envs whose top-k the drift could reorder is printed, 0 when they are
    bitwise), positions equal on the rest. The card's ms per step, reset
    and sample ms.
27. glimpse study: ``apx_torch.ops.glimpse_study.run_study`` at apx's
    geometry (N = 4096, 64x64x3, 10x10 sensor, 32 chained steps, CUDA
    graph, CUDA events): every variant's us per batch in apx's chain (its
    footprints stay in L2), in the chain that moves 0.2 per axis a step and
    alone, and its max |error| against the float64 oracle, K3 and tap2
    within 1e-5 of the fp32 plain form, the row gathers, and K3's launches
    in it.
28. parse_trace on the card's traces: ``bench.profile`` of the eager
    LIDARLocRooms-v0 loop at N = 4096 writes its chrome trace;
    ``apx_torch.tools.parse_trace`` reads it: its device activities per
    step equal ``kernel_launches_per_step`` and their summed time is within
    1% of ``device_busy_ms_per_step``; the union busy time, the idle share
    and the five longest idle gaps with the host event over each. Then one
    trace of four replays of the captured graph chunk: busy ms and
    activities per step as CUPTI records them inside the graph (or a line
    saying it recorded none), the idle share against the same replays'
    wall time with the profiler off and against the profiled wall (which
    holds CUPTI's host cost on the first traced graph launch).
29. one line naming the parts that need gymnasium, pillow or imageio
    (absent here) and the CPU test files that cover them.
30. K1 on the window-frame backends' windows at N = 4096 (the casts of
    phase 3): ``"windowed"``'s 18x18 (scans) and 6x6 (moves) windows and
    ``"mxu_window"``'s 16x16 ones, bitwise the plain form; device, plain
    and bound ms of each. Device ms of ``bitslab2d``'s plain pieces: its
    bit window and its three rho-sliced lattice casts.
31. raycast backends: ``LIDARLocRooms-v0`` at N = 4096 under each of
    ``bitslab2d``, ``bitslab``, ``windowed``, ``hybrid``, ``mxu_window``,
    ``pallas``, ``xla``, ``bitslab2d`` with ``beam_rects="on"`` and the beam
    tables, reset and 50 steps (lidar in [0, 1], rewards in [-2.9, 0.1], the
    kernels launched as ``backend_launches`` says: R at the reset and per
    step wherever the reset scans the whole map, else K1 typed; S per step
    under ``xla`` and ``pallas``, else F1 4 and K1 3 fast per step, no fast
    cast under the bit windows, 2 under the tables); card vs CPU at N = 256
    for 30 steps, bitwise; the graph ms per step against the default in one
    process (``bench.bench_ab``, 128 steps, default, variant, variant,
    default); ``bench.profile`` of ``bitslab2d``.
32. samplers: ``TinyImageNetLoc-v0``'s explicit reset with
    ``"streamed"`` at N = 16384 (ms and peak memory; the card's scores
    against the CPU's on every 1024th env within 3e-6), with
    ``"streamed"``, ``"chunked"`` (K3 launched 27 + 2 times) and the
    cartesian sweep at N = 4096, and the cartesian sweep at N = 16384 (or
    a line saying it does not fit).
33. image storage: ``tin_loc`` (100,000 images) at N = 4096 under
    ``image_storage`` ``"packed"``, ``"flat"``, ``"gather"`` and under
    ``glimpse_window="rows"``, 20 steps from the ``"array"`` run's draws:
    obs and rewards bitwise (the row window's glimpses bitwise the plain
    ``"off"`` form and within 1e-6 of K3's), K3 launched as under
    ``"array"`` (2 at the reset, 3 per step; none under the row window);
    graph ms per step of each against ``"array"`` / ``"off"`` in one
    process; K3 by index over the 1.23 GB bank, K3 on the gathered rows and
    the row gather itself.
34. sharded bank: ``selftest --shard-bank`` on two gloo ranks on cuda:0 for
    ``LIDARLocRooms-v0`` (N = 4096, 30 steps) and the episodic
    ``CircleSquare-v0`` (34 steps), at once: each rank's block bitwise the
    replicated solo run's, each rank holding only its bank block and
    reporting N1 and S and R (LIDAR) or K3 (CircleSquare) launches, the
    bytes per step of its fetches; ``bench --distributed --shard-bank``
    (eager ms per step replicated and sharded, interleaved).

35. PPO on the card (``apx_torch.examples.train_ppo_lidar``) at its
    published width: ``LIDARLocRooms-v0``, N = 1024, rollout 32, 2 epochs x
    4 minibatches, 3 iterations. Losses and rewards finite, every weight
    finite, the prediction gradient (through the env) nonzero on ``pred``,
    ``trunk`` and the encoder and zero on ``policy`` and ``value``; the
    launches in each iteration (counts set to 0 just before it) S, R and
    F2 once per rollout step, and R once at the reset. Per iteration the
    rollout ms (with its prediction backward) and the update ms;
    env-steps/s including the update after the first iteration; peak
    memory.
36. one PPO iteration at N = 64, rollout 8 on the card and on the CPU from
    the same weights and draws (made on the CPU, injected), TF32 off: mean
    rewards within rtol 1e-5, every weight within TRAIN_NET_TOL.
37. the learners on a grid: ``apx_torch.examples.grid_selftest`` on four
    gloo ranks sharing cuda:0 (2 x 2 (data, model)), N = 256, rollout 16,
    TF32 off: the mesh PPO equal to its one-process run (rewards rtol 1e-5,
    each rank's trunk rows within TRAIN_NET_TOL, 128 rows per rank), two
    V-trace iterations (behavior == learner, bitwise) and two R2D2
    iterations (ptr == filled == 2, target == online), each equal to its
    one-process run (rewards rtol 1e-5, the trunk's first-iteration
    gradient within 1e-5 of its largest entry); the dry run
    (``apx_torch.graft_entry.dryrun_multichip``) on two gloo ranks on
    cuda:0: its sharded rollouts and training loss equal to one process.
38. the trainer's resume on the card, in a subprocess (``chip_smoke.py
    --train-resume`` with deterministic algorithms and
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``): N = 256, rollout 16, saved after 2
    iterations; the restored run's net, Adam state, obs, env state and
    generator after 2 more bitwise the uninterrupted run's.
Then K3 on ``apx_torch.graft_entry.entry()`` (the flagship CircleSquare,
16x16, N = 64): 1 launch at the reset and 2 in its step; its glimpses at
the reset's and the step's images and positions against the plain form.

Then a ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Each kernel's ``launches`` is counted on
its own path, the counts set to 0 just before it: S's, R's and F2's on
phase 4 (and under ``"window"`` on phase 9, ``"sparse_metrics"`` on phase
13), K1's and F1's on phase 9 (0 on phase 4: S and R cast there), K2's on
phase 9, N1-N3's on phase 15, L's on phase 12,
K3's on phase 6 (and phase 13, under ``"tin_loc"`` on phase 15,
and per geometry on the MNIST-v0 and CIFAR10-v0 runs of phase 16), K4's in
``measure()``; K1's and K3's ``"sharded"`` entries are each rank's counts
on phases 18-19, set to 0 in the worker just before its sharded rollout;
their ``"compat"`` entries are the counts on each phase-24 path; K3's
``"glimpse_study"`` entry its launches in phase 27 (set to 0 just before);
K3's, S's and R's ``"workloads"`` entries their launches on each phase-17
workload path (set to 0 just before each), with the kernel's time on that
path's inputs; K1's, F1's, F2's, S's and R's ``"backends"`` their launches
on each phase-31 path, K3's ``"chunked"`` and ``"storage"`` entries its
launches on the phase-32 chunked reset and on each phase-33 path (each set
to 0 just before); the ``"train"`` entries of S, R and F2 their launches in
each phase-35 iteration, K3's ``"entry"`` its launches on ``entry()``.
Every process it starts is killed at PHASE_TIMEOUT_S. It needs CUDA and
the apx_torch package beside it, and exits non-zero without them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (dense): HBM bytes/s and float32 operations/s
# outside the tensor cores (an FMA counts as two operations); the import
# fails where chip_smoke.py stands without the repo.
from apx_torch.core.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S
from apx_torch.ops._launch import clear_launches, launched
# float32 instructions issued per second: half of FP32_OPS_PER_S, where an
# FMA is one instruction (132 SMs x 128 lanes x 1.98 GHz). K1, K3 and K4
# are counted in instructions (min, max, compare and select are one each,
# as an FMA is), so they are priced at this rate.
FP32_ISSUE_PER_S = FP32_OPS_PER_S / 2
# Instructions per (ray, candidate cell) of K1: fast = max, min, compare,
# and, select, min-reduce; typed adds the clips, the crossing/graze
# compares and the three graze reductions.
OPS_PER_CELL = {"raycast_fast": 6, "raycast_typed": 12}
# Instructions of the glimpse: per sample row or column of an env, its
# coordinate (centre, FMA, offset, add, clip: 9) and its tap pair (floor,
# two hats: 11); per output element the 4-term bilinear (6 mul, 3 add) and
# the clip (2), and for a uint8 image the conversion of its four taps
# (one instruction each, the least a conversion takes).
OPS_PER_GLIMPSE_TAP = 20
OPS_PER_GLIMPSE = {torch.float32: 11, torch.uint8: 15}
GLIMPSE_TOL = 1e-6
N = 4096
TIN_BANK = 100_000  # TinyImageNet's split: the 1.23 GB bank of phases 21 and 33


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph and replayed, timed with CUDA events, so the host's
    launch overhead is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def candidate_cells(occ, origin, targets) -> int:
    """Cells, summed over the casts, that can hold a candidate: a cell
    passes a <= b only if its column's slab pair has near <= 1 and far >= 0
    and its row's does too, so only the hull of such columns times the hull
    of such rows can (the cull K1 does; for a segment inside the map it lies
    in the segment's bounding box with a one-cell margin, clipped to the
    map). Computed with the plain form's slab pairs on these inputs."""
    from apx_torch.ops.raycast import _slab_axis

    _, h, w = occ.shape
    o = origin[:, None, :]
    d = targets - o

    def hull(size, axis):
        lo = torch.arange(size, dtype=torch.float32, device=occ.device)
        near, far = _slab_axis(o[..., axis:axis + 1], d[..., axis:axis + 1], lo, lo + 1.0)
        ok = (near <= 1.0) & (far >= 0.0)
        idx = torch.arange(size, device=occ.device)
        first = torch.where(ok, idx, size).amin(-1)
        last = torch.where(ok, idx, -1).amax(-1)
        return (last - first + 1).clamp_min(0)

    return int((hull(w, 0) * hull(h, 1)).sum())


def bound(name: str, occ, origin, targets) -> tuple[float, str]:
    """Least time (ms) for the cast: each input read once (occ as bytes,
    origin, targets, seg), the output written once, at the HBM rate; the
    per-cell instructions over the cells that can hold a candidate
    (``candidate_cells``) at the float32 issue rate. Returns (ms,
    bound_by)."""
    n, h, w = occ.shape
    r = targets.shape[1]
    nbytes = n * h * w + 4 * (n * 2 + n * r * 2 + n * r + n * r)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = candidate_cells(occ, origin, targets) * OPS_PER_CELL[name] / FP32_ISSUE_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


EDGE_MAPS = {"rooms": (32, 32), "maze": (21, 21), "random24x16": (24, 16),
             "random7x5": (7, 5), "random1x1": (1, 1)}
EDGE_RAYS = (1, 2, 3, 8, 33)
EDGE_N = 1003  # not a multiple of K1's 8 envs per block


def edge_maps(kind: str, n: int, rng) -> np.ndarray:
    """(n, H, W) bool maps of one ``EDGE_MAPS`` kind: apx's rooms (32x32)
    or maze (21x21) generators over 8 seeds, or random walls (35%)."""
    from apx_torch.data.floor_map import generate_maze_map, generate_rooms_map

    if kind in ("rooms", "maze"):
        gen = generate_rooms_map if kind == "rooms" else generate_maze_map
        maps = np.stack([gen(i) for i in range(8)])
        return maps[rng.integers(0, len(maps), n)]
    return rng.random((n, *EDGE_MAPS[kind])) < 0.35


def edge_casts(occ: np.ndarray, r: int, rng, centres: bool = False):
    """One origin per map of ``occ`` (n, H, W) and r segments each, float32
    (n, 2) and (n, r, 2), drawn to probe the slab test's exact edges.
    ``centres``: origins at free-cell centres (any cell where none is
    free) casting the 8 beams of range 5, where corner grazes occur.
    Otherwise origins are generic points, cell centres, lattice points or
    on a cell face, and each segment is one of: a random angle and length,
    axis-aligned (dx or dy exactly 0), zero length, a beam of range 5,
    leaving the map, past a map corner (its box is the whole map), or
    ending on a lattice point."""
    from apx_torch.ops.raycast import lidar_directions_np

    n, h, w = occ.shape
    size = np.array([w, h], np.float64)
    rows = np.arange(n)
    beams = lidar_directions_np(8).astype(np.float64) * 5.0
    if centres:
        score = np.where(occ.reshape(n, -1), 0.0, 1.0) + rng.random((n, h * w))
        flat = score.argmax(-1)  # a random free cell, if any
        origin = (np.stack([flat % w, flat // w], -1) + 0.5).astype(np.float32)
        d = beams[np.arange(r) % 8][None]
        return origin, (origin[:, None] + d).astype(np.float32)
    p = rng.uniform(0, 1, (n, 2)) * size
    face = p.copy()
    axis = rng.integers(0, 2, n)
    face[rows, axis] = np.round(face[rows, axis])
    origin = np.stack([p, np.floor(p) + 0.5, np.round(p), face])[rng.integers(0, 4, n), rows]
    origin = origin.astype(np.float32).astype(np.float64)
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    unit = np.stack([np.cos(ang), np.sin(ang)], -1)
    span = float(max(h, w))
    corner = np.where(rng.random((n, r, 2)) < 0.5, -1.0, size + 1.0)
    kinds = np.stack([
        unit * rng.uniform(0, 6, (n, r, 1)),
        np.eye(2)[rng.integers(0, 2, (n, r))] * rng.uniform(-6, 6, (n, r, 1)),
        np.zeros((n, r, 2)),
        beams[rng.integers(0, 8, (n, r))],
        unit * rng.uniform(span, 3 * span, (n, r, 1)),
        corner - origin[:, None],
        np.round(origin[:, None] + unit * rng.uniform(0, 6, (n, r, 1))) - origin[:, None],
    ])
    d = kinds[rng.integers(0, len(kinds), (n, r)), rows[:, None], np.arange(r)[None]]
    return origin.astype(np.float32), (origin[:, None] + d).astype(np.float32)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).astype(np.float32)


def _wide_f32(rng, n: int, lo: int, hi: int) -> np.ndarray:
    """n float32 values with random signs, 24-bit mantissas and exponents in
    [lo, hi] (subnormal below -126, rounded there)."""
    mant = 1.0 + rng.integers(0, 2**23, n) / 2.0**23
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    return _f32(sign * np.ldexp(mant, rng.integers(lo, hi + 1, n)))


def numerics_cases(seed: int = 0, n_random: int = 4096) -> dict:
    """Inputs that probe the exact-rounding kernels (N1-N3) at their edges,
    float32 numpy arrays: ``"fma"`` (a, b, c), ``"sqrt"`` x and
    ``"sum_squares"`` {K: (rows, K)} for K = 2, 3, 5. Hand-built cases
    first: a*b + c on an exact tie between two float32 values (at scales
    down into the subnormals), sticky bits far below the ulp (a tie of the
    product moved by c = +-2^-k, where a float64 sum would round onto the
    tie), subnormal and underflowing results, signed zeros (a*b = +-0 with
    c = +-0, exact cancellation), results at and past the overflow
    threshold, inf * 0, inf - inf and NaN; then ``n_random`` triples over
    wide exponents (c near a*b's magnitude, so that sums cancel). The
    roots: zeros, subnormals, perfect squares and their neighbours, the
    largest float, inf, negatives and NaN, and random values over every
    exponent. The rows: the same kinds of values."""
    rng = np.random.default_rng(seed)
    inf, nan, fmax, tiny = np.inf, np.nan, float(np.finfo(np.float32).max), 2.0**-149
    rows = []  # (a, b, c) in float64, each exactly a float32
    # Exact ties: a = i 2^-12, b = j 2^-12 (i, j odd), c in [1, 2): the sum's
    # residue below c's ulp is exactly half an ulp; scaled by 2^s into the
    # subnormals and up, with random signs.
    k = 256
    i, j = rng.integers(0, 2**10, k) * 2 + 1, rng.integers(0, 2**10, k) * 2 + 1
    c = 1.0 + rng.integers(0, 2**23, k) / 2.0**23
    s1, s2 = rng.integers(-75, 60, k), rng.integers(-75, 60, k)
    sg = np.where(rng.random((3, k)) < 0.5, -1.0, 1.0)
    rows += list(zip(sg[0] * np.ldexp(i / 2.0**12, s1), sg[1] * np.ldexp(j / 2.0**12, s2),
                     sg[2] * np.ldexp(c, s1 + s2)))
    # Sticky bits: (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 is a tie; c = +-2^-q
    # decides it from far below the ulp (q up to 149, the last subnormal).
    t = 1.0 + 2.0**-12
    for q in (30, 48, 53, 60, 80, 100, 126, 149):
        for sc in (1.0, -1.0):
            rows += [(t, t, sc * 2.0**-q), (-t, t, sc * 2.0**-q), (t, -t, -sc * 2.0**-q)]
    rows += [(1.0 + 2.0**-23, 2.0**-24 * (1.0 + 2.0**-23), 1.0), (3 * 2.0**-12, 2.0**-12, 1.0),
             (1.0 - 2.0**-24, 2.0**-24, 1.0), (1.0 + 2.0**-23, 2.0**-24, 1.0)]
    # Subnormal and underflowing results.
    for a_, b_ in ((2.0**-75, 2.0**-75), (2.0**-75 * (1 + 2.0**-23), 2.0**-75),
                   (2.0**-70, 2.0**-70), (2.0**-100, 2.0**-49), (2.0**-80, 2.0**-80),
                   (tiny, 0.5), (tiny, 1.5), (2.0**-126, 1.0 - 2.0**-24)):
        for c_ in (0.0, -0.0, tiny, -tiny, 2.0**-126, -2.0**-127):
            rows += [(a_, b_, c_), (-a_, b_, c_)]
    a_ = _wide_f32(rng, 64, -90, -60).astype(np.float64)
    b_ = _wide_f32(rng, 64, -90, -60).astype(np.float64)
    rows += list(zip(a_, b_, _wide_f32(rng, 64, -149, -120).astype(np.float64)))
    # Signed zeros.
    for za in (0.0, -0.0, 1e-30, -1e-30):
        for zb in (1.0, -1.0, 0.0, -0.0, 1e-30):
            for zc in (0.0, -0.0):
                rows.append((float(np.float32(za)), float(np.float32(zb)), zc))
    rows += [(1.0, -1.0, 1.0), (-1.0, -1.0, -1.0), (3.0, 0.5, -1.5), (0.1, 3.0, -0.3)]
    # Overflow: p past the largest float, sums at and past the threshold
    # (fmax + 2^103 is a tie that rounds to inf).
    rows += [(2.0**64, 2.0**64, 0.0), (fmax, 1.0, fmax), (fmax, -1.0, -fmax), (fmax, 2.0, -fmax),
             (2.0**52, 2.0**51, fmax), (2.0**52, -2.0**51, -fmax),
             (2.0**52 * (1 - 2.0**-24), 2.0**51, fmax), (fmax, fmax, -inf), (fmax, 1.0, 2.0**103)]
    # inf, NaN.
    rows += [(inf, 0.0, 1.0), (0.0, -inf, 1.0), (inf, 1.0, -inf), (inf, 2.0, 1.0),
             (-inf, 2.0, 1.0), (1.0, 1.0, inf), (1.0, 1.0, -inf), (inf, -1.0, -inf),
             (nan, 1.0, 1.0), (1.0, nan, 0.0), (1.0, 1.0, nan), (inf, 0.0, nan)]
    # Random triples over wide exponents, c near a*b's magnitude.
    a_, b_ = _wide_f32(rng, n_random, -60, 60), _wide_f32(rng, n_random, -60, 60)
    near = _f32(-(a_.astype(np.float64) * b_) * (1 + rng.normal(0, 2.0**-rng.integers(
        1, 30, n_random))))
    far = _wide_f32(rng, n_random, -149, 127)
    c_ = np.where(rng.random(n_random) < 0.7, near, far)
    rows += list(zip(a_.astype(np.float64), b_.astype(np.float64), c_.astype(np.float64)))
    abc = _f32(np.array(rows, dtype=np.float64))  # the few inexact ones (0.1) rounded

    squares = _f32(np.arange(1, 4097, dtype=np.float64) ** 2)
    x = np.concatenate([
        _f32([0.0, -0.0, tiny, 2 * tiny, 3 * tiny, 2.0**-127, 2.0**-126, 1.0, 2.0, 4.0, fmax,
              inf, -1.0, -tiny, -inf, nan, 1.0 - 2.0**-24, 1.0 + 2.0**-23]),
        squares, np.nextafter(squares, np.float32(0)), np.nextafter(squares, np.float32(inf)),
        np.abs(_wide_f32(rng, n_random, -149, 127)),
        np.abs(_wide_f32(rng, 256, -149, -120)),
    ]).astype(np.float32)

    def rows_of(width: int) -> np.ndarray:
        vals = np.concatenate([_wide_f32(rng, 512 * width, -80, 70),
                               _wide_f32(rng, 64 * width, -149, -60),
                               _wide_f32(rng, 64 * width, 60, 127)])
        special = _f32([0.0, -0.0, tiny, -tiny, inf, -inf, nan, fmax, 1.0])
        vals[rng.integers(0, len(vals), 8 * width)] = special[rng.integers(0, len(special),
                                                                          8 * width)]
        return vals.reshape(-1, width)

    return {"fma": (abc[:, 0].copy(), abc[:, 1].copy(), abc[:, 2].copy()), "sqrt": x,
            "sum_squares": {width: rows_of(width) for width in (2, 3, 5)}}


def phase_edge_casts(dev) -> int:
    """K1 bitwise against its plain form on ``edge_casts`` over every
    ``EDGE_MAPS`` kind, R in ``EDGE_RAYS``, both kernels, N = ``EDGE_N``.
    Returns the number of casts checked."""
    from apx_torch.ops import raycast_cuda
    from apx_torch.ops.raycast import raycast_grid

    rng = np.random.default_rng(5)
    checked = 0
    for kind in EDGE_MAPS:
        occ_np = edge_maps(kind, EDGE_N, rng)
        occ = torch.from_numpy(occ_np).to(dev)
        for r in EDGE_RAYS:
            for centres in (False, True):
                origin, targets = (torch.from_numpy(x).to(dev)
                                   for x in edge_casts(occ_np, r, rng, centres))
                for typed, kernel in ((False, raycast_cuda.raycast_fast),
                                      (True, raycast_cuda.raycast_typed)):
                    got = kernel(occ, origin, targets)
                    want = raycast_grid(occ, origin, targets, geos_typing=typed)[0]
                    torch.cuda.synchronize()
                    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                          f"{kernel.__name__} on {kind} edge casts, R={r}, centres={centres}: "
                          f"not bitwise equal (max |diff| {(got - want).abs().max().item()})")
                    checked += got.numel()
    return checked


def kernel_inputs(bank, gen, dev):
    """N=4096 casts on rooms maps: generic origins inside free cells with
    the step's three ray sets, and cell-centre origins for the reset scan."""
    from apx_torch.ops.raycast import lidar_directions_np

    bank_pos = torch.randint(0, bank.num_maps, (N,), generator=gen, device=dev)
    occ = bank.fetch(bank_pos)
    k = torch.randint(0, 2**62, (N,), generator=gen, device=dev) % bank.free_counts[bank_pos]
    flat = bank.free_cells[bank_pos, k]
    w = bank.map_hw[1]
    centre = torch.stack([flat % w, flat // w], -1).to(torch.float32) + 0.5
    origin = centre + (torch.rand((N, 2), generator=gen, device=dev) - 0.5) * 0.9
    move = (torch.rand((N, 1, 2), generator=gen, device=dev) * 2 - 1) * 0.7
    slide = torch.eye(2, device=dev) * torch.rand((N, 1, 2), generator=gen, device=dev)
    beams = torch.from_numpy(lidar_directions_np(8) * np.float32(5.0)).to(dev)
    return {
        "raycast_fast": [(occ, origin, origin[:, None] + move),
                         (occ, origin, origin[:, None] + slide),
                         (occ, origin, origin[:, None] + beams)],
        "raycast_typed": [(occ, centre, centre[:, None] + beams)],
    }


def phase_kernels(dev) -> list[dict]:
    from apx_torch.data.floor_map import make_rooms_bank
    from apx_torch.ops import raycast_cuda
    from apx_torch.ops.raycast import raycast_grid, seg_length

    gen = torch.Generator(device=dev).manual_seed(1)
    bank = make_rooms_bank(256, device=dev)
    rows = []
    for name, cases in kernel_inputs(bank, gen, dev).items():
        kernel = getattr(raycast_cuda, name)
        typed = name == "raycast_typed"
        per_r = {}
        for occ, origin, targets in cases:
            seg = seg_length(targets - origin[:, None])
            got = kernel(occ, origin, targets, seg)
            want = raycast_grid(occ, origin, targets, seg, geos_typing=typed)[0]
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            err = (got - want).abs().max().item()
            check(same, f"{name} R={targets.shape[1]} not bitwise equal to its plain form "
                        f"(max |diff| {err})")
            if typed:
                grazes = int((got == 0).sum())  # single-point grazes report 0
                check(grazes > 0, "the typed scan from cell centres met no graze")
            r = targets.shape[1]
            own = kernel(occ, origin, targets)  # no lengths: the kernel computes |d|
            torch.cuda.synchronize()
            check(torch.equal(own.view(torch.int32), got.view(torch.int32)),
                  f"{name} R={r} with seg=None not bitwise its call with seg_length's lengths")
            ms = device_ms(lambda: kernel(occ, origin, targets, seg), 50)
            plain_ms = device_ms(
                lambda: raycast_grid(occ, origin, targets, seg, geos_typing=typed), 4)
            b_ms, b_by = bound(name, occ, origin, targets)
            per_r[r] = {"ms": ms, "own_len_ms": device_ms(lambda: kernel(occ, origin, targets), 50),
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "max_abs_err": err}
        main_r = max(per_r)  # the beam scan's R = 8
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "apx_torch/csrc/raycast_slab.cu",
            "replaces": "apx/ops/raycast_pallas.py:40",
            "launches": None,
            "max_abs_err": max(v["max_abs_err"] for v in per_r.values()),
            **{k: per_r[main_r][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,  # no single PyTorch call computes a slab raycast
            "shape": f"N={N} R={main_r} H=W=32",
            "by_r": per_r,
        })
    return rows


def glimpse_bound(images, pos, sensor, scale) -> tuple[float, str]:
    """Least time (ms) for the glimpse: the pixels its hats touch in each
    image (distinct nonzero-weight rows x columns, from these positions),
    the positions and the output, each once, at the HBM rate; its
    instructions (the taps once per sample row and column of each env, the
    bilinear and clip per output) at the float32 issue rate. Returns (ms,
    bound_by)."""
    from apx_torch.ops.glimpse import glimpse_coords, interp_weights

    n, h, w, c = images.shape
    rows, cols = glimpse_coords(pos, (h, w), sensor, scale)
    n_rows = (interp_weights(rows, h) > 0).any(dim=1).sum(dim=-1)
    n_cols = (interp_weights(cols, w) > 0).any(dim=1).sum(dim=-1)
    outputs = n * sensor[0] * sensor[1] * c
    nbytes = int((n_rows * n_cols).sum()) * c * images.element_size() + pos.numel() * 4 \
        + outputs * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = outputs * OPS_PER_GLIMPSE[images.dtype] + n * (sensor[0] + sensor[1]) * OPS_PER_GLIMPSE_TAP
    t_ops = ops / FP32_ISSUE_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def glimpse_inputs(dev) -> dict:
    """N=4096 glimpses at CircleSquare's geometry (images from its float32
    bank) and, of seeded random uint8 bytes, TinyImageNet's (64x64x3, 10x10
    sensor), MNIST's (28x28x1, 5x5) and CIFAR10's (32x32x3, 5x5); positions
    uniform in [-1, 1)^2 with the corners and edge midpoints first."""
    from apx_torch.data.circle_square import make_circle_square_bank

    gen = torch.Generator(device=dev).manual_seed(2)
    edges = torch.tensor([[1, 1], [-1, -1], [1, -1], [-1, 1], [0, 1], [1, 0], [-1, 0],
                          [0, -1], [1, 0.37], [-0.81, -1]], dtype=torch.float32, device=dev)

    def positions():
        pos = torch.rand((N, 2), generator=gen, device=dev) * 2 - 1
        pos[:len(edges)] = edges
        return pos

    bank = make_circle_square_bank(device=dev)
    cs = bank.images[torch.randint(0, bank.length, (N,), generator=gen, device=dev)]

    def u8(h, w, c):
        return torch.randint(0, 256, (N, h, w, c), generator=gen, device=dev, dtype=torch.uint8)

    return {"circle_square": (cs, positions(), (5, 5), 1.0),
            "tiny_imagenet": (u8(64, 64, 3), positions(), (10, 10), 1.0),
            "mnist": (u8(28, 28, 1), positions(), (5, 5), 1.0),
            "cifar10": (u8(32, 32, 3), positions(), (5, 5), 1.0)}


def glimpse_library(images, pos, sensor, scale):
    """The library yardstick of K3 (the port never calls it): one
    ``grid_sample`` on the float32 NCHW images at the kernel's
    coordinates, clipped to [0, 1]; returns the call."""
    import torch.nn.functional as F

    from apx_torch.ops.glimpse import glimpse_coords

    n, h, w, c = images.shape
    img = images.to(torch.float32)
    if images.dtype == torch.uint8:
        img = img / 255.0
    img = img.permute(0, 3, 1, 2).contiguous()
    rows, cols = glimpse_coords(pos, (h, w), sensor, scale)
    grid = torch.stack(torch.broadcast_tensors(
        (cols / (w - 1) * 2 - 1)[:, None, :], (rows / (h - 1) * 2 - 1)[:, :, None]), dim=-1)

    def library():
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                             align_corners=True).clamp(0.0, 1.0)

    return library


def phase_glimpse_kernel(dev) -> dict:
    from apx_torch.ops.glimpse import extract_glimpse_batch
    from apx_torch.ops.glimpse_cuda import glimpse

    # The plain form's products run in full float32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    per_geom = {}
    for geom, (images, pos, sensor, scale) in glimpse_inputs(dev).items():
        got = glimpse(images, pos, sensor, scale)
        want = extract_glimpse_batch(images, pos, sensor, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= GLIMPSE_TOL, f"glimpse at {geom}: max |diff| {err} > {GLIMPSE_TOL}")
        check(bool(((got >= 0) & (got <= 1)).all()), f"glimpse at {geom} outside [0, 1]")
        n, h, w, c = images.shape
        library = glimpse_library(images, pos, sensor, scale)
        lib_err = (library().permute(0, 2, 3, 1) - got).abs().max().item()
        b_ms, b_by = glimpse_bound(images, pos, sensor, scale)
        per_geom[geom] = {
            "shape": f"N={n} {h}x{w}x{c} {str(images.dtype).split('.')[-1]}, "
                     f"{sensor[0]}x{sensor[1]} sensor",
            "ms": device_ms(lambda: glimpse(images, pos, sensor, scale), 50),
            "plain_ms": device_ms(lambda: extract_glimpse_batch(images, pos, sensor, scale), 4),
            "library_ms": device_ms(library, 50),
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err, "library_max_abs_err": lib_err,
        }
    main = per_geom["circle_square"]
    return {
        "name": "glimpse",
        "route": "cuda",
        "source": "apx_torch/csrc/glimpse.cu",
        "replaces": "apx/ops/glimpse_pallas.py:73",
        "launches": None,
        "max_abs_err": max(v["max_abs_err"] for v in per_geom.values()),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "by_geometry": per_geom,
    }


# The launch key (``ops._launch.launched``) of each kernels row: its kernel
# id, or its entry where the id has more than one.
ROW_KEYS = {"raycast_fast": "K1.raycast_fast_launch", "raycast_typed": "K1.raycast_typed_launch",
            "window": "K2", "glimpse": "K3", "chain": "K4", "fma": "N1", "sum_squares": "N2",
            "sqrt": "N3", "lidar_step": "F1", "merge": "F2", "fused_step": "S",
            "fused_reset": "R", "light_dark_step": "L.light_dark_step_launch",
            "light_dark_reset": "L.light_dark_reset_launch"}
NUMERICS = ("N1", "N2", "N3")


def launch_counts(keys, table: dict | None = None) -> dict:
    """The counts (``ops._launch.launched``) of ``keys``, kernel ids or
    entries, in the launch table or in ``table``, a copy of it (a selftest
    rank's report)."""
    return {k: launched(k, table) for k in keys}


def kernel_launches(nonzero: bool = False) -> dict:
    """The counts of every row's key but N1-N3's (``numerics_launches``);
    with ``nonzero``, those above 0 only."""
    counts = launch_counts(k for k in ROW_KEYS.values() if k not in NUMERICS)
    return {k: v for k, v in counts.items() if v or not nonzero}


NUMERICS_BY_PATH: dict[str, dict] = {}  # N1-N3's counts on each path driven, for the kernels line


def numerics_launches(path: str, steps: int, roots: bool | None = True) -> dict:
    """N1-N3's counts on ``path`` since the last reset, and per step (the
    reset's launches included). Checks that the path launched each of them
    (an FMA, a sum of squares and a root on the card: the move's |a|, the
    rewards, a metrics wrapper's distance), or, for a LIDAR path whose
    roots are all in the step (``roots`` false), that it launched no N3:
    F1 took them; ``roots`` None checks nothing (the bit windows' plain
    casts compute their own roots). Keeps the counts under the path's
    name in NUMERICS_BY_PATH."""
    counts = launch_counts(NUMERICS)
    if roots:
        check(all(counts.values()), f"{path}: N1-N3 launches {counts}, expected each > 0")
    elif roots is not None:
        check(counts["N3"] == 0, f"{path}: N3 launched {counts['N3']} times beside F1")
    counts["per_step"] = {k: counts[k] / steps for k in NUMERICS}
    NUMERICS_BY_PATH[path] = {"steps": steps, **counts}
    return counts


# ---- N1-N3: XLA's contracted float32 arithmetic (core.numerics) --------------

NUMERICS_RANDOM = 2**20  # random inputs held bitwise per kernel
NUMERICS_REPLACES = {
    "fma": "apx/envs/lidar_localization.py:560 (pos + direction * d2w, which XLA contracts "
           "into one FMA in its fusion; no Pallas kernel)",
    "sum_squares": "apx/envs/lidar_localization.py:540 (jnp.sum(jnp.square(action)), XLA-CPU's "
                   "fused reduce; no Pallas kernel)",
    "sqrt": "apx/ops/raycast_pallas.py:106 (jnp.linalg.norm's root, fed to the Pallas call; no "
            "Pallas kernel)",
}


def _bits_equal(got, want) -> bool:
    """Bitwise equal, any NaN equal to any NaN."""
    nan = torch.isnan(want)
    return got.shape == want.shape and torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _numel_read(*xs) -> int:
    """Elements an operand list reads once: each tensor's own elements (a
    broadcast view's distinct ones), a Python float none."""
    return sum(int(np.prod([n for n, s in zip(x.shape, x.stride()) if s != 0]))
               for x in xs if isinstance(x, torch.Tensor))


def numerics_bound(name: str, args, out) -> tuple[float, str]:
    """Least time (ms) of N1-N3 on these operands: each read once, the
    output written once, at the HBM rate; the float32 operations (an FMA
    2, a product 1, a root 1) at the peak float32 rate."""
    nbytes = 4 * (_numel_read(*args) + out.numel())
    if name == "fma":
        ops = 2 * out.numel()
    elif name == "sum_squares":
        ops = out.numel() * (2 * args[0].shape[-1] - 1)
    else:
        ops = out.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def phase_numerics_kernels(dev) -> list[dict]:
    """N1-N3 (``core.numerics`` on CUDA tensors) against their plain forms
    (``fma_plain``, ``sum_squares_plain``, ``sqrt_plain``: the float64
    emulation, on the card), bitwise with NaN as NaN: on
    ``numerics_cases(0)``, on NUMERICS_RANDOM random inputs each (the call
    sites' layouts: (n, 2) against (n, 1) against a Python float, stride-2
    slices), and at the main paths' N = 4096 shapes, where each is timed
    (CUDA-graph replay) against its plain form and against one PyTorch
    call (``torch.addcmul``, ``torch.linalg.vecdot``, ``torch.sqrt``;
    timed only, with whether its bits agree). One launch per call.
    Returns the three kernels rows."""
    from apx_torch.core.numerics import fma, fma_plain, sqrt, sqrt_plain, sum_squares
    from apx_torch.core.numerics import sum_squares_plain

    kernels = {"fma": (fma, fma_plain), "sum_squares": (sum_squares, sum_squares_plain),
               "sqrt": (sqrt, sqrt_plain)}
    held = {k: 0 for k in kernels}

    def hold(name, args, what):
        kernel, plain = kernels[name]
        before = launched(ROW_KEYS[name])
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        count = launched(ROW_KEYS[name]) - before
        check(count == 1, f"{name} on {what}: {count} launches, not 1")
        err = (got - want).abs().nan_to_num(0.0).max().item() if got.numel() else 0.0
        check(_bits_equal(got, want), f"{name} on {what}: not bitwise its plain form "
                                      f"(max |diff| {err})")
        held[name] += got.numel()
        return got

    def t(xs):
        return tuple(torch.from_numpy(x).to(dev) for x in xs)

    cases = numerics_cases(0)
    hold("fma", t(cases["fma"]), "numerics_cases")
    hold("sqrt", t([cases["sqrt"]]), "numerics_cases")
    for width, rows in cases["sum_squares"].items():
        hold("sum_squares", t([rows]), f"numerics_cases rows of {width}")

    rng = np.random.default_rng(16)
    half = NUMERICS_RANDOM // 2
    wide = t([_wide_f32(rng, NUMERICS_RANDOM, -60, 60).reshape(half, 2),
              _wide_f32(rng, half, -60, 60).reshape(half, 1),
              _wide_f32(rng, NUMERICS_RANDOM, -120, 120).reshape(half, 2)])
    a, b, c = wide
    hold("fma", (a, b, 0.1), f"{NUMERICS_RANDOM} random, ({half}, 2) x ({half}, 1) + 0.1")
    hold("fma", (a[:, 0], a[:, 1], c[:, 0]), f"{half} random, stride-2 slices")
    hold("fma", (a, b, c), f"{NUMERICS_RANDOM} random, (n, 2) x (n, 1) + (n, 2)")
    hold("sum_squares", (c,), f"{half} random rows of 2")
    hold("sum_squares", (a[::2],), "random rows of 2, every other row")
    hold("sqrt", (c.abs().reshape(-1),), f"{NUMERICS_RANDOM} random")
    hold("sqrt", (c[:, 1].abs(),), f"{half} random, a stride-2 slice")

    # The main paths' shapes at N = 4096: LIDAR's pos1 = fma(direction,
    # d2w[:, None], pos), its base reward's sum_squares(action), the
    # length's root.
    gen = torch.Generator(device=dev).manual_seed(16)
    direction = torch.rand((N, 2), generator=gen, device=dev) * 2 - 1
    d2w = torch.rand((N, 1), generator=gen, device=dev)
    pos = torch.rand((N, 2), generator=gen, device=dev) * 32
    shapes = {
        "fma": ((direction, d2w, pos), f"N={N}: (N, 2) x (N, 1) + (N, 2)",
                lambda: torch.addcmul(pos, direction, d2w)),
        "sum_squares": ((direction,), f"N={N}: (N, 2) rows",
                        lambda: torch.linalg.vecdot(direction, direction)),
        "sqrt": ((d2w[:, 0] * 9,), f"N={N}: (N,)", lambda: torch.sqrt(d2w[:, 0] * 9)),
    }
    rows = []
    for name, (args, shape, library) in shapes.items():
        kernel, plain = kernels[name]
        got = hold(name, args, shape)
        lib_out = library()
        b_ms, b_by = numerics_bound(name, args, got)
        rows.append({
            "name": name, "route": "cuda", "source": "apx_torch/csrc/numerics.cu",
            "replaces": NUMERICS_REPLACES[name], "launches": None, "max_abs_err": 0.0,
            "ms": device_ms(lambda: kernel(*args), 50),
            "plain_ms": device_ms(lambda: plain(*args), 10),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(library, 50),
            "library_call": {"fma": "torch.addcmul", "sum_squares": "torch.linalg.vecdot",
                             "sqrt": "torch.sqrt"}[name],
            "library_bitwise": _bits_equal(lib_out, got),
            "library_bits_differ": int((lib_out.view(torch.int32) != got.view(torch.int32)).sum()),
            "shape": shape, "elements_held_bitwise": None,
        })
    for r in rows:
        r["elements_held_bitwise"] = held[r["name"]]
    return rows


# ---- F1, F2: the LIDAR step's arithmetic and the NEXT_STEP merge -------------

LIDAR_STEP_REPLACES = "apx/envs/lidar_localization.py:538-615 (the step's arithmetic around " \
                      "the casts, which XLA fuses; no Pallas kernel)"
MERGE_REPLACES = "apx/core/env.py:254-387 (NEXT_STEP's masked merge, loss and reward, which " \
                 "XLA fuses; no Pallas kernel)"
# float32 operations per env of each F1 stage, counted from the source
# (an FMA 2, a root or a division 1, a compare or select 1): (fixed, per
# beam).
LIDAR_STEP_OPS = {"a": (34, 0), "b": (22, 0), "c": (30, 2), "d": (4, 3)}


def lidar_step_cases(seed: int, n: int) -> dict:
    """Inputs of F1's four stages (``ops.lidar_step``), float32 numpy, n
    envs: random actions in [-1.5, 1.5]^2 after the edge actions (zeros,
    |a| exactly 1, |a| > 1, a tiny |a|, +-inf, NaN, components at the
    wall-slide's 1e-5); positions over a 32x32 map after its corners and
    edges; the window bases ``floor(pos) - 7``; for stage B the distances
    to the wall (0: at an adjacent wall, |a| itself, |a| less 1e-5 and its
    neighbours, NaN) as fractions of |a|, which the caller scales; for
    stage C the candidates' distances (0, -0, tiny, positive), the odometry
    flags and origins; for stage D beam distances with NaN, -0 and values
    past the range."""
    rng = np.random.default_rng(seed)
    edge = _f32([[0, 0], [-0.0, 0.0], [1, 0], [0, 1], [-1, 0], [0.6, 0.8], [3, 4], [-5, 5],
                 [1e-6, 0], [1e-20, 0], [0, -1e-30], [0.70710677, 0.70710677], [2e-5, 2e-5],
                 [1e-5, 1e-5], [1.0000001e-5, 0], [1e-38, 1e-38], [np.nan, 0], [np.inf, 1],
                 [-np.inf, -np.inf], [-1, -1]])
    action = _f32(rng.uniform(-1.5, 1.5, (n, 2)))
    action[:len(edge)] = edge
    pos = _f32(rng.uniform(0, 32, (n, 2)))
    pos[:8] = _f32([[0.5, 0.5], [31.5, 31.5], [0, 0], [32, 16], [16, 0], [1e-7, 3],
                    [0.5, 31.9999], [5, 5]])
    # d2w as a multiple of |a|: 1 (no wall), 0 (a wall at the start), and
    # |a| - d2w at the slide's 1e-5 threshold (set by the caller).
    frac = _f32(rng.uniform(0, 1, n))
    frac[:64:4] = 1.0
    frac[1:64:4] = 0.0
    rem = _f32(rng.choice([0.0, 1e-5, 1.0000001e-5, 9.999999e-6, 2e-5, 5e-6], n))
    cand_dist = _f32(rng.uniform(-0.1, 1, (n, 2)))
    cand_dist[:40, 0] = _f32(rng.choice([0.0, -0.0, 1e-30, 1.0], 40))
    cand_dist[40:60] = 0.0
    dist = _f32(rng.uniform(-1, 7, (n, 8)))
    dist[0, :4] = _f32([np.nan, -0.0, 5.0, 5.0000005])
    return {"action": action, "pos": pos, "base": _f32(np.floor(pos) - 7), "frac": frac,
            "rem": rem, "rem_every": 3, "cand_dist": cand_dist,
            "odo_pending": rng.uniform(size=n) < 0.3,
            "initial_pos": _f32(rng.uniform(0, 32, (n, 2))), "dist": dist}


def lidar_step_inputs(cases: dict, dev) -> dict:
    """The stages' operands on ``dev`` from ``lidar_step_cases``: stage A's
    plain outputs give direction and |a|; d2w = frac |a|, and on every
    ``rem_every``-th env |a| - rem (the slide at its threshold)."""
    from apx_torch.ops import lidar_step

    t = {k: torch.from_numpy(v).to(dev) for k, v in cases.items() if isinstance(v, np.ndarray)}
    a = lidar_step.stage_a(t["action"], t["pos"], True)
    d2w = a["total"] * t["frac"]
    every = slice(None, None, cases["rem_every"])
    d2w[every] = a["total"][every] - t["rem"][every]
    return {**t, "a": a, "d2w": d2w}


def lidar_step_stage_args(x: dict, params) -> dict:
    """Each stage's positional operands (after the plain stages before it),
    keyed by stage; ``params`` a LIDARLocRooms-v0 params for the map size,
    its reciprocals and the beams."""
    from apx_torch.ops import lidar_step

    a = x["a"]
    b = lidar_step.stage_b(x["pos"], a["direction"], a["total"], x["d2w"])
    c_args = (x["pos"], b["pos1"], a["total"], b["rem"], b["n_keep"], b["cand"], b["cand_diag"],
              x["cand_dist"], x["odo_pending"], x["initial_pos"], params.map_size,
              params.inv_map_size, params.beam_offsets)
    c = lidar_step.stage_c(*c_args)
    return {"a": [(x["action"], x["pos"], True, None), (x["action"], x["pos"], True, x["base"]),
                  (x["action"], x["pos"], False, None)],
            "b": [(x["pos"], a["direction"], a["total"], x["d2w"])],
            "c": [c_args],
            "d": [(x["dist"], c["pos"], c["initial_pos"], params.inv_range, params.inv_map_size)]}


FUSED_STEP_REPLACES = "apx/envs/lidar_localization.py:538-615 (the whole step: three casts, " \
                      "apx/ops/raycast_pallas.py:40's function on the whole map, and the " \
                      "arithmetic XLA fuses around them)"
FUSED_RESET_REPLACES = "apx/envs/lidar_localization.py:493-537 with _observe (the reset: the " \
                       "map's fetch, the spawn and the GEOS-typed scan; no Pallas kernel)"
FUSED_BANKS = (("LIDARLocRooms-v0", "rooms 32x32"), ("LIDARLocMaze-v0", "maze 21x21"))


def fused_inputs(dev, env_id: str, n: int, seed: int) -> dict:
    """Kernel S's and R's operands from ``env_id`` on ``dev``: S's from the
    states after a reset and three steps, with ``lidar_step_cases``' actions
    (its edge actions first: zeros, |a| exactly 1 and above, tiny, at the
    slide's threshold, infinite and NaN), its corner, edge and lattice
    positions (scaled to the map) on the first envs, and its odometry
    flags; R's from one reset's draws through ``MapBank.spawn``. Returns
    {"step": args, "reset": args (typed), "reset_untyped": args}."""
    import apx_torch

    venv, params = apx_torch.make_vec(env_id, num_envs=n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    zero = torch.zeros((n, 2), device=dev)
    _, state, _ = venv.reset(params, gen)
    for _ in range(3):
        act = torch.rand((n, 2), generator=gen, device=dev) * 2 - 1
        _, state, *_ = venv.step(state, {"action": act, "prediction": zero}, params, gen)
    inner = venv.env.split_counter(state.inner)[1]
    cases = lidar_step_cases(seed, n)
    w = params.map_bank.map_hw[1]
    pos = inner.pos.clone()
    pos[:8] = torch.from_numpy(cases["pos"][:8] * np.float32(w / 32.0)).to(dev)
    step = (inner.occ.contiguous(), torch.from_numpy(cases["action"]).to(dev), pos,
            torch.from_numpy(cases["odo_pending"]).to(dev), inner.initial_pos.contiguous(),
            params.map_size, params.inv_map_size, params.beam_offsets, params.inv_range)
    draws = venv.env.draw_reset(n, params, gen)
    words, flat, _ = params.map_bank.spawn(draws["bank_pos"], draws["k"])
    reset = (words, flat, w, params.beam_offsets, params.lidar_range, params.inv_map_size)
    return {"step": step, "reset": (*reset, True), "reset_untyped": (*reset, False)}


def fused_casts(step_args) -> list:
    """The (origin, targets) of S's three casts on these operands, as its
    plain form makes them."""
    from apx_torch.ops import lidar_fused, lidar_step

    occ = step_args[0]
    casts = []

    def cast(origin, targets, seg=None):
        casts.append((origin, targets))
        return lidar_fused.whole_map_cast(occ, typed=False)(origin, targets, seg)

    lidar_step.staged_step(lidar_step, *step_args[1:], cast, cast, cast)
    return casts


def _as_read(name: str, args) -> tuple:
    """The operands S or R reads: R given ``fetch`` (its ninth operand)
    reads the bank's rows, spawn cells and indices that the draws select,
    and the draws, in place of the whole bank."""
    if name == "fused_step" or len(args) < 9 or args[8] is None:
        return args
    bank_pos, k, indices = args[8]
    return (args[0][bank_pos], args[1][bank_pos, k], *args[2:8], bank_pos, k,
            indices[bank_pos])


def fused_bound(name: str, args, out) -> tuple[float, str]:
    """Least time (ms) of S or R on these operands: every operand read once
    and every output written once at the HBM rate (R reads the row words,
    not a map); the casts' per-cell instructions over the cells these casts
    can hit (``candidate_cells``) and the stages' float32 operations
    (``LIDAR_STEP_OPS``; R: a division and a clamp per beam) at the float32
    rates."""
    from apx_torch.ops import lidar_fused

    args = _as_read(name, args)
    nbytes = _tree_bytes(args, out)
    if name == "fused_step":
        occ, n, beams = args[0], args[0].shape[0], args[7].shape[0]
        cells = sum(candidate_cells(occ, o, t) for o, t in fused_casts(args))
        t_ops = (cells * OPS_PER_CELL["raycast_fast"] / FP32_ISSUE_PER_S
                 + n * sum(a + b * beams for a, b in LIDAR_STEP_OPS.values()) / FP32_OPS_PER_S)
    else:
        words, flat, w, offsets, _, _, typed = args[:7]
        occ, pos = lidar_fused.spawn_leaves(words, flat, w)
        cells = candidate_cells(occ, pos, pos[:, None, :] + offsets)
        kind = "raycast_typed" if typed else "raycast_fast"
        t_ops = (cells * OPS_PER_CELL[kind] / FP32_ISSUE_PER_S
                 + 3 * out["lidar"].numel() / FP32_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * t_ops, "operations") if t_ops >= t_bytes else (1e3 * t_bytes, "bytes")


def hold_fused(name: str, args, time_it: bool = True) -> dict:
    """S (``fused_step``) or R (``fused_reset``) against its plain form
    (``ops.lidar_fused``) on ``args``, every output bitwise with NaN as
    NaN, launched exactly once; with ``time_it`` the kernel's and the plain
    form's device ms (CUDA-graph replay) and the bound. Returns the
    measurements and the number of outputs held."""
    from apx_torch.ops import lidar_fused, lidar_fused_cuda

    kernel = lidar_fused_cuda.step if name == "fused_step" else lidar_fused_cuda.reset
    plain = lidar_fused.step_plain if name == "fused_step" else lidar_fused.reset_plain
    key = ROW_KEYS[name]
    before = launched(key)
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    check(launched(key) == before + 1, f"{name}: {launched(key) - before} launches, not 1")
    check(list(got) == list(want), f"{name}: outputs {list(got)}, plain {list(want)}")
    for k in want:
        check(_bits_equal_any(got[k], want[k]), f"{name} output {k} is not bitwise its plain form")
    res = {"held": sum(v.numel() for v in want.values()), "max_abs_err": 0.0}
    if time_it:
        b_ms, b_by = fused_bound(name, args, want)
        res.update(ms=device_ms(lambda: kernel(*args), 50),
                   plain_ms=device_ms(lambda: plain(*args), 4), bound_ms=b_ms, bound_by=b_by,
                   bytes=_tree_bytes(_as_read(name, args), want))
    return res


def phase_fused_kernels(dev) -> list[dict]:
    """S and R against their plain forms on the card at N = 4096 on the
    rooms (32x32) and maze (21x21) banks (``fused_inputs``), bitwise with
    NaN as NaN, R typed and untyped; each timed (CUDA-graph replay) against
    its plain form and its bound. Returns the kernels rows of S and R (the
    rooms bank's times; R typed)."""
    by_bank = {"fused_step": {}, "fused_reset": {}, "fused_reset_untyped": {}}
    held = {"fused_step": 0, "fused_reset": 0}
    for env_id, label in FUSED_BANKS:
        x = fused_inputs(dev, env_id, N, 29)
        for key, name, args in (("fused_step", "fused_step", x["step"]),
                                ("fused_reset", "fused_reset", x["reset"]),
                                ("fused_reset_untyped", "fused_reset", x["reset_untyped"])):
            res = hold_fused(name, args)
            held[name] += res.pop("held")
            by_bank[key][label] = res
    rows = []
    for name, source_rep in (("fused_step", FUSED_STEP_REPLACES),
                             ("fused_reset", FUSED_RESET_REPLACES)):
        main = by_bank[name][FUSED_BANKS[0][1]]
        rows.append({"name": name, "route": "cuda", "source": "apx_torch/csrc/lidar_fused.cu",
                     "replaces": source_rep, "launches": None, "max_abs_err": 0.0,
                     **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                     "library_ms": None,  # no PyTorch call computes a LIDAR step or reset
                     "shape": f"N={N} {FUSED_BANKS[0][1]}, 8 beams"
                              + ("" if name == "fused_step" else ", typed scan"),
                     "by_bank": by_bank[name], "elements_held_bitwise": held[name]})
    rows[1]["untyped_by_bank"] = by_bank["fused_reset_untyped"]
    rows[1]["masks"] = fused_reset_masks(dev)
    rows[1]["merge_after_reset"] = merge_after_reset(dev)
    return rows


def fused_reset_masks(dev, n: int = 16384) -> dict:
    """R (typed) at N = ``n`` on the rooms bank, as the NEXT_STEP main path
    launches it (reading the bank itself, given ``prev_done``): held
    bitwise to the plain form (``reset_plain``, reading the bank as
    ``MapBank.spawn`` does) unmasked and, on the envs each mask selects,
    given masks that select no env, one in 101 (random) and every env
    (``mask_0``, ``mask_1_in_101``, ``mask_all``). Device ms per launch
    (CUDA-graph replay): on ``MapBank.spawn``'s gathered operands unmasked
    (``gathered``), reading the bank unmasked (``fetch``), and given each
    mask, with R's counter and without it (``no_counter``); the spawn's
    three gathers alone (``spawn``)."""
    import apx_torch
    from apx_torch.core import trace
    from apx_torch.ops import lidar_fused, lidar_fused_cuda

    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", num_envs=n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    d = venv.env.draw_reset(n, p, gen)
    bank = p.map_bank
    scan = (bank.map_hw[1], p.beam_offsets, p.lidar_range, p.inv_map_size, True)
    fetch = {"fetch": (d["bank_pos"], d["k"], bank.indices)}
    words, flat, _ = bank.spawn(d["bank_pos"], d["k"])
    masks = {"mask_0": torch.zeros(n, dtype=torch.bool, device=dev),
             "mask_1_in_101": torch.rand(n, generator=gen, device=dev) < 1 / 101,
             "mask_all": torch.ones(n, dtype=torch.bool, device=dev)}

    def fused(only=None):
        return lidar_fused_cuda.reset(bank.row_words, bank.free_cells, *scan, only=only, **fetch)

    want = lidar_fused.reset_plain(bank.row_words, bank.free_cells, *scan, **fetch)
    got = fused()
    check(list(got) == list(want), f"R reading the bank: outputs {list(got)}, not {list(want)}")
    for k, v in want.items():
        check(_bits_equal_any(got[k], v), f"R reading the bank: output {k} is not the plain form's")
    for name, only in masks.items():
        plain = lidar_fused.reset_plain(bank.row_words, bank.free_cells, *scan, only=only, **fetch)
        got = fused(only)
        for k, v in plain.items():
            check(_bits_equal_any(got[k][only], v[only]),
                  f"R given {name}: output {k} is not the plain form's on the envs it selects")
    out = {"n": n, "selected_1_in_101": int(masks["mask_1_in_101"].sum()),
           "gathered": device_ms(lambda: lidar_fused_cuda.reset(words, flat, *scan), 50),
           "fetch": device_ms(fused, 50),
           "spawn": device_ms(lambda: bank.spawn(d["bank_pos"], d["k"]), 50)}
    for name, only in masks.items():
        out[name] = device_ms(lambda only=only: fused(only), 50)
    counter = trace.reset_counter
    try:  # R given a mask and no counter: the launch without its count
        trace.reset_counter = lambda device: None
        out["no_counter"] = {name: device_ms(lambda only=only: fused(only), 50)
                             for name, only in masks.items()}
    finally:
        trace.reset_counter = counter
    return out


def merge_after_reset(dev, n: int = 16384, steps: int = 16, replays: int = 8) -> dict:
    """F2's device us per launch beside R's and S's, in a captured
    ``steps``-step NEXT_STEP chunk of LIDARLocRooms-v0 at N = ``n`` with no
    env done (as 100 steps in 101 of the ``lidar_rooms`` cell): R given
    ``prev_done`` (``masked``, the main path) and R resetting every env
    (``unmasked``, as before the mask). Both graphs in one process, warmed
    alternately for 3 s, then profiled ``replays`` replays at a time in the
    order masked, unmasked, unmasked, masked."""
    import apx_torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from apx_torch.envs.lidar_localization import LIDARLocalizationEnv

    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", num_envs=n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(37)
    obs, state, _ = venv.reset(p, gen)
    draws = [venv.env.draw_reset(n, p, gen) for _ in range(steps)]
    act = [{"action": torch.rand((n, 2), generator=gen, device=dev) * 2 - 1,
            "prediction": torch.randn((n, 2), generator=gen, device=dev)} for _ in range(steps)]

    def chunk():
        s = state
        for j in range(steps):
            _, s, *_ = venv.step(s, act[j], p, reset_draws=draws[j], step_draws={})
        return s

    masked = LIDARLocalizationEnv.autoreset_from_draws
    graphs = {}
    for name in ("masked", "unmasked"):
        if name == "unmasked":
            LIDARLocalizationEnv.autoreset_from_draws = \
                lambda self, draws, old_state, params, only=None: masked(self, draws, old_state,
                                                                          params)
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                chunk()
            torch.cuda.current_stream().wait_stream(side)
            graphs[name] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[name]):
                chunk()
        finally:
            LIDARLocalizationEnv.autoreset_from_draws = masked
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3.0:
        for graph in graphs.values():
            graph.replay()
        torch.cuda.synchronize()
    kernels = {"F2": "apx_merge_next_step", "R": "apx_lidar_fused_reset",
               "S": "apx_lidar_fused_step"}
    out = {name: {k: [] for k in kernels} for name in graphs}
    for name in ("masked", "unmasked", "unmasked", "masked"):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(replays):
                graphs[name].replay()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        for k, key in kernels.items():
            hits = [e for e in events if key in e.key]
            out[name][k].append(sum(e.self_device_time_total for e in hits)
                                / max(1, sum(e.count for e in hits)))
    return {"n": n, "steps": steps, "replays": replays, "us_per_launch": out}


def _tree_bytes(*trees) -> int:
    total = 0
    for tree in trees:
        for v in (tree.values() if isinstance(tree, dict) else tree):
            if isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
    return total


def merge_inputs(dev, env_id: str, n: int, seed: int, grad: bool = False):
    """One NEXT_STEP step's merge operands from ``env_id`` on ``dev`` (the
    inner env's step and reset after a reset and a few steps, half the
    envs masked), as ``VectorAPEnv._merged_step`` passes them to
    ``ops.merge.next_step``: (args, kwargs)."""
    import apx_torch

    venv, params = apx_torch.make_vec(env_id, num_envs=n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    zero = torch.zeros((n, 2), device=dev)
    _, state, _ = venv.reset(params, gen)
    for _ in range(3):
        act = torch.rand((n, 2), generator=gen, device=dev) * 2 - 1
        _, state, *_ = venv.step(state, {"action": act, "prediction": zero}, params, gen)
    t = state.inner.t.clone()
    t[:8] = venv.env.max_episode_steps - 1  # runs out of time this step
    inner_env, inner, counter = venv.env.split_counter(dataclasses.replace(state.inner, t=t))
    act = torch.rand((n, 2), generator=gen, device=dev) * 2 - 1
    pred = torch.rand((n, 2), generator=gen, device=dev) * 2 - 1
    pred[:4] = torch.tensor([[np.nan, 0], [0, 0], [1, -1], [np.inf, 0]], device=dev)
    if grad:
        pred.requires_grad_()
    r = inner_env.step_env(inner, act, pred, params, venv.env.draw_step(n, params, gen))
    reset = inner_env.autoreset_from_draws(venv.env.draw_reset(n, params, gen), inner, params)
    mask = torch.rand(n, generator=gen, device=dev) < 0.5
    return ((mask, (r.obs, r.state, r.info), reset, r.base_reward, r.terminated, r.truncated,
             pred, r.prediction_target, venv.env.loss_fn(params)),
            {"derived": inner_env.obs_derived_spec(params), "counter": counter})


def merged_leaves(m) -> list:
    """Every tensor of a ``Merged``, in a fixed order (None kept)."""
    from apx_torch.core.env import tree_map

    out = []
    tree_map(out.append, (m.obs, m.state, m.info))
    out += [m.derived.get(k) if m.derived else None for k in sorted(m.derived or {})]
    return out + [m.base_reward, m.terminated, m.truncated, m.done, m.loss, m.reward, m.t,
                  m.time_obs]


def _bits_equal_any(got, want) -> bool:
    if got is None or want is None:
        return got is None and want is None
    if got.dtype.is_floating_point:
        return _bits_equal(got.detach(), want.detach())
    return got.shape == want.shape and torch.equal(got, want)


# One dense NEXT_STEP LIDAR step on the card: S and R once each, F2 once;
# no standalone K1 or F1 launch and no N1-N3.
DENSE_STEP = {"N1": 0, "N2": 0, "N3": 0, "F1": 0, "F2": 1, "K1.raycast_fast_launch": 0,
              "K1.raycast_typed_launch": 0, "S": 1, "R": 1}


def phase_lidar_step_kernels(dev) -> list[dict]:
    """F1 (``ops.lidar_step_cuda``, four stages) and F2
    (``ops.merge_cuda``) against their plain forms (``ops.lidar_step``,
    ``ops.merge``: the op-by-op PyTorch, N1-N3 at its rounding sites) on
    the card, bitwise with NaN as NaN: F1's stages on ``lidar_step_cases``
    at N = 4096 (stage A with and without the unfused length, in the map
    and in a window frame); F2 on a step of LIDARLocRooms-v0 (the map obs
    four cells a thread), LIDARLocMaze-v0 (21x21: a cell a thread) and
    LightDark-v0 (rounded squares, no derived obs) at N = 4096, half the
    envs reset, eight running out of time, and its gradient in the
    prediction against the plain form's. Each is timed (CUDA-graph replay)
    against its plain form and its bound (bytes at 3.35 TB/s, the operations
    at the float32 rate). Then one dense LIDARLocRooms-v0 step, counted
    from 0 (``DENSE_STEP``: S 1, R 1, F2 1, no K1, F1 or N1-N3),
    and S and R against their plain forms (``phase_fused_kernels``).
    Returns the kernels rows of F1, F2, S and R."""
    import apx_torch
    from apx_torch.ops import lidar_step, lidar_step_cuda, merge, merge_cuda

    _, params = apx_torch.make_vec("LIDARLocRooms-v0", num_envs=N, device=dev)
    cases = lidar_step_cases(17, N)
    x = lidar_step_inputs(cases, dev)
    stage_args = lidar_step_stage_args(x, params)
    by_stage, held = {}, 0
    for stage, calls in stage_args.items():
        kernel = getattr(lidar_step_cuda, f"stage_{stage}")
        plain = getattr(lidar_step, f"stage_{stage}")
        for args in calls:
            key = f"F1.lidar_step_{stage}_launch"
            before = launched(key)
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(launched(key) == before + 1,
                  f"F1 stage {stage}: {launched(key) - before} launches")
            check(set(got) == set(want), f"F1 stage {stage}: outputs {sorted(got)}")
            for k in want:
                check(_bits_equal_any(got[k], want[k]),
                      f"F1 stage {stage} output {k} is not bitwise its plain form")
                held += 0 if want[k] is None else want[k].numel()
        args = calls[0]
        out = kernel(*args)
        nbytes = _tree_bytes(args, out)
        b_ms = max(nbytes / HBM_BYTES_PER_S * 1e3,
                   N * (LIDAR_STEP_OPS[stage][0] + LIDAR_STEP_OPS[stage][1]
                        * params.lidar_beam_count) / FP32_OPS_PER_S * 1e3)
        by_stage[stage] = {
            "ms": device_ms(lambda: kernel(*args), 50),
            "plain_ms": device_ms(lambda: plain(*args), 10),
            "bound_ms": b_ms, "bytes": nbytes,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S * 1e3 >= b_ms else "operations"}
    f1 = {"name": "lidar_step", "route": "cuda", "source": "apx_torch/csrc/lidar_step.cu",
          "replaces": LIDAR_STEP_REPLACES, "launches": None, "max_abs_err": 0.0,
          **{k: sum(s[k] for s in by_stage.values()) for k in ("ms", "plain_ms", "bound_ms")},
          "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in by_stage.values())
          else "operations",
          "library_ms": None, "shape": f"N={N}, 8 beams; ms = the four stages of one step",
          "by_stage": by_stage, "elements_held_bitwise": held}

    merge_rows, m_held = {}, 0
    for env_id in ("LIDARLocRooms-v0", "LIDARLocMaze-v0", "LightDark-v0"):
        args, kw = merge_inputs(dev, env_id, N, 18)
        before = launched("F2")
        got = merge_cuda.next_step(*args, **kw)
        want = merge.next_step(*args, **kw)
        torch.cuda.synchronize()
        check(launched("F2") == before + 1, f"F2 on {env_id}: not one launch")
        for i, (g, w) in enumerate(zip(merged_leaves(got), merged_leaves(want), strict=True)):
            check(_bits_equal_any(g, w), f"F2 on {env_id}: output {i} not bitwise its plain form")
            m_held += 0 if w is None else w.numel()
        # The gradient in the prediction, through the loss and the reward.
        gargs, gkw = merge_inputs(dev, env_id, N, 19, grad=True)
        weights = torch.rand(N, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
        grads = []
        for fn in (merge_cuda.next_step, merge.next_step):
            m = fn(*gargs, **gkw)
            (g,) = torch.autograd.grad((m.reward * weights).sum() + 0.5 * m.loss.sum(), gargs[6])
            grads.append(g)
        check(_bits_equal(grads[0], grads[1]), f"F2 on {env_id}: prediction gradient differs")
        # Each leaf is read from one side per env (the step's or the
        # reset's, of equal sizes), the merged leaves and the derived obs
        # written, the per-env vectors read and written once.
        nbytes = _tree_bytes(merged_leaves(want)) + _tree_bytes(_leaves_of(args[1])) + _tree_bytes(
            [args[0], args[3], args[4], args[5], args[6], args[7], kw["counter"].t])
        merge_rows[env_id] = {
            "ms": device_ms(lambda: merge_cuda.next_step(*args, **kw), 20),
            "plain_ms": device_ms(lambda: merge.next_step(*args, **kw), 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes}
    main = merge_rows["LIDARLocRooms-v0"]
    f2 = {"name": "merge", "route": "cuda", "source": "apx_torch/csrc/merge.cu",
          "replaces": MERGE_REPLACES, "launches": None, "max_abs_err": 0.0,
          **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
          "library_ms": None, "shape": f"LIDARLocRooms-v0 N={N}: 8 leaves + 32x32 map obs",
          "by_env": merge_rows, "elements_held_bitwise": m_held, "gradient_bitwise": True}

    # One dense step, counted from 0.
    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", num_envs=N, device=dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    _, state, _ = venv.reset(params, gen)
    act = torch.rand((N, 2), generator=gen, device=dev) * 2 - 1
    torch.cuda.synchronize()
    clear_launches()
    venv.step(state, {"action": act, "prediction": torch.zeros((N, 2), device=dev)}, params, gen)
    torch.cuda.synchronize()
    got = launch_counts(DENSE_STEP)
    check(got == DENSE_STEP, f"a dense LIDAR step launched {got}, expected {DENSE_STEP}")
    s_row, r_row = phase_fused_kernels(dev)
    for r in (f1, f2, s_row, r_row):
        r["launches_one_step"] = got[ROW_KEYS[r["name"]]]
    return [f1, f2, s_row, r_row]


# ---- L: LightDark's step and reset (ops.light_dark_cuda) ----------------------

LIGHT_DARK_REPLACES = {
    "light_dark_step": "apx/envs/light_dark.py:78-107 (the step: move, wall test, clip, noisy "
                       "observation, base reward, which XLA fuses; no Pallas kernel)",
    "light_dark_reset": "apx/envs/light_dark.py:78-107 (the reset's noisy observation, XLA "
                        "fusions; no Pallas kernel)",
}
LIGHT_DARK_NS = (N, 16384)  # the main paths' N and the benchmark cell's


def light_dark_cases(seed: int, n: int) -> dict:
    """L's operands, float32 numpy arrays ``pos``, ``action`` and ``noise``,
    each (n, 2) (the reset reads ``pos`` and ``noise``). Hand-built rows
    first: zero actions (signed zeros), |a| exactly 1 and one ulp above,
    moves from p = 1 - f32(0.15) +- 8 ulps by a unit action on each axis
    and sign (so that the moved position lands exactly on |p| = 1, just
    short of it and one ulp beyond), positions at the light (brightness 1, no
    noise), noise that drives the observation past +-2 (and inf noise),
    NaN, inf and subnormal actions, NaN noise; then random rows: positions
    in [-1, 1), actions in [-1.5, 1.5) (a third of them past |a| = 1),
    N(0, 1/2) noise, one in a hundred times 100."""
    rng = np.random.default_rng(seed)
    inf, nan = np.inf, np.nan
    up = float(np.nextafter(np.float32(1), np.float32(2)))
    rows = []  # (px, py, ax, ay, zx, zy)
    for p in ((0.3, 0.2), (0.0, -0.7)):
        rows += [(*p, 0.0, 0.0, 0.5, -0.5), (*p, -0.0, 0.0, 0.5, -0.5), (*p, 0.0, -0.0, 0.0, 0.0)]
    for a in ((1.0, 0.0), (0.0, -1.0), (-1.0, 0.0), (0.6, 0.8), (up, 0.0), (0.0, -up), (up, up)):
        rows.append((0.1, -0.2, *a, 0.3, 0.1))
    x = np.float32(1) - np.float32(0.15)
    for _ in range(8):
        x = np.nextafter(x, np.float32(0))
    for _ in range(17):
        v = float(x)
        rows += [(v, 0.0, 1.0, 0.0, 0.1, 0.1), (-v, 0.5, -1.0, 0.0, 0.1, 0.1),
                 (0.0, v, 0.0, 1.0, 0.1, 0.1), (-0.5, -v, 0.0, -1.0, 0.1, 0.1)]
        x = np.nextafter(x, np.float32(1))
    rows += [(0.0, -0.7, 0.0, 0.0, 3.0, -3.0), (0.0, -0.7, 0.0, 0.0, inf, 1.0),
             (0.9, 0.9, 0.1, 0.1, 50.0, 50.0), (-0.9, 0.9, 0.0, 0.0, -50.0, 60.0),
             (0.9, -0.9, 0.0, 0.0, inf, -inf)]
    rows += [(0.2, 0.2, nan, 0.0, 0.1, 0.1), (0.2, 0.2, 0.0, nan, 0.1, 0.1),
             (0.2, 0.2, nan, nan, 0.1, 0.1), (0.2, 0.2, inf, 0.0, 0.1, 0.1),
             (0.2, 0.2, -inf, inf, 0.1, 0.1), (0.2, 0.2, 1e-40, 0.0, 0.1, 0.1),
             (0.2, 0.2, 0.5, 0.5, nan, 0.0)]
    if n < len(rows):
        raise ValueError(f"light_dark_cases: n = {n} < {len(rows)} hand-built rows")
    edge = _f32(np.array(rows, dtype=np.float64))
    k = n - len(rows)
    noise = rng.normal(0.0, np.sqrt(0.5), (k, 2)) * np.where(rng.random((k, 1)) < 0.01, 100, 1)
    rand = _f32(np.concatenate([rng.uniform(-1, 1, (k, 2)), rng.uniform(-1.5, 1.5, (k, 2)),
                                noise], axis=1))
    cases = np.concatenate([edge, rand])
    return {"pos": cases[:, 0:2].copy(), "action": cases[:, 2:4].copy(),
            "noise": cases[:, 4:6].copy()}


def hold_light_dark(x: dict, params, time_it: bool = True) -> dict:
    """L's step and reset (``light_dark_cuda``) against their plain forms
    (``envs.light_dark.step_plain`` and ``noisy_position``, N1-N3 and ATen
    on the card) on the CUDA tensors ``x`` (``light_dark_cases``' keys):
    every output bitwise with NaN as NaN, one launch per call; with
    ``time_it`` each entry's and its plain form's device ms (CUDA-graph
    replay) and the bytes bound. Returns {kernel: measurements}."""
    from apx_torch.envs import light_dark as ld
    from apx_torch.ops import light_dark_cuda

    pos, action, noise = x["pos"], x["action"], x["noise"]
    light, h2, scale = params.light_pos, params.light_height_sq, params.folded_noise_scale
    forms = {
        "light_dark_step": (
            lambda: light_dark_cuda.step(pos, action, noise, light, h2, params.move_scale, scale),
            lambda: ld.step_plain(pos, action, noise, params), (pos, action, noise)),
        "light_dark_reset": (
            lambda: (light_dark_cuda.reset(pos, noise, light, h2, scale),),
            lambda: (ld.noisy_position(pos, noise, scale, params),), (pos, noise)),
    }
    res = {}
    for name, (kernel, plain, read) in forms.items():
        key = ROW_KEYS[name]
        before = launched(key)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(launched(key) == before + 1, f"{name}: {launched(key) - before} launches, not 1")
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            check(_bits_equal_any(g, w), f"{name} output {i} at N={pos.shape[0]} is not bitwise "
                                         "its plain form")
        nbytes = _tree_bytes(read, want)
        res[name] = {"held": sum(w.numel() for w in want), "bytes": nbytes}
        if time_it:
            res[name].update(ms=device_ms(kernel, 50), plain_ms=device_ms(plain, 10),
                             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return res


def phase_light_dark_kernel(dev) -> list[dict]:
    """L against its plain forms on the card at N = 4096 and 16384
    (``light_dark_cases``), bitwise with NaN as NaN, each entry timed
    (CUDA-graph replay) against its plain form and its bytes bound (an
    entry's float32 operations, ~30 an env, are 1% of its bytes' time).
    Returns the rows of L's step and reset (N = 4096's times; ``by_n``
    holds both sizes)."""
    import apx_torch

    _, params = apx_torch.make_vec("LightDark-v0", num_envs=N, device=dev)
    by_n = {"light_dark_step": {}, "light_dark_reset": {}}
    for n in LIGHT_DARK_NS:
        x = {k: torch.from_numpy(v).to(dev) for k, v in light_dark_cases(23 + n, n).items()}
        for name, r in hold_light_dark(x, params).items():
            by_n[name][n] = r
    rows = []
    for name, sizes in by_n.items():
        main = sizes[N]
        rows.append({"name": name, "route": "cuda", "source": "apx_torch/csrc/light_dark.cu",
                     "replaces": LIGHT_DARK_REPLACES[name], "launches": None, "max_abs_err": 0.0,
                     **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                     "library_ms": None,  # no PyTorch call computes a LightDark step or reset
                     "shape": f"N={N} (N, 2) leaves", "by_n": sizes,
                     "elements_held_bitwise": sum(r["held"] for r in sizes.values())})
    return rows


WINDOW_PAD = 16  # LIDARLocRooms-v0's ray_pad under "pallas_window"


def window_bound(occ, starts, pad: int) -> tuple[float, str]:
    """Least time (ms) for K2 on these inputs: per env the window's cells
    that lie inside the map read once (the rest is padding, written as
    zeros), the (24, 16) window written once and the starts read, at the
    HBM rate; it does no float operations."""
    from apx_torch.ops.window import WIN, WIN_ROWS, clamp_starts

    n, h, w = occ.shape
    x0, y0 = clamp_starts(starts.to(torch.int64), h + 2 * pad, w + 2 * pad, WIN)
    rows = ((y0 - pad + WIN_ROWS).clamp(max=h) - (y0 - pad).clamp(min=0)).clamp(min=0)
    cols = ((x0 - pad + WIN).clamp(max=w) - (x0 - pad).clamp(min=0)).clamp(min=0)
    nbytes = int((rows * cols).sum()) + n * (WIN_ROWS * WIN + 2 * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_window_kernels(dev) -> tuple[dict, dict]:
    """K2 against its plain form (with word loads and with byte loads, and
    against the padded copy), then on out-of-range starts, then K1 on K2's
    windows.
    Returns K2's kernels row and K1's window measurements by kernel name
    and R."""
    from apx_torch.data.floor_map import make_maze_bank, make_rooms_bank
    from apx_torch.ops import raycast_cuda
    from apx_torch.ops.raycast import pad_occupancy, raycast_grid, seg_length
    from apx_torch.ops.window import WIN, WIN_ROWS, clamp_starts, window_starts
    from apx_torch.ops.window import extract_windows as plain_windows
    from apx_torch.ops.window_cuda import extract_windows

    pad = WINDOW_PAD
    gen = torch.Generator(device=dev).manual_seed(3)
    bank = make_rooms_bank(256, device=dev)
    occ = bank.fetch(torch.randint(0, bank.num_maps, (N,), generator=gen, device=dev))
    pos = torch.rand((N, 2), generator=gen, device=dev) * 32
    edges = torch.tensor([[0, 0], [32, 32], [0, 32], [32, 0], [16, 0], [0, 16], [32, 16],
                          [16, 32], [31.999998, 0.5], [7.999999, 8.0]], device=dev)
    pos[:len(edges)] = edges
    starts, _ = window_starts(pos, WIN, pad)
    want = plain_windows(occ, starts, pad)
    # The same maps one byte past a word: the kernel reads them by bytes.
    occ_bytes = torch.zeros(occ.numel() + 1, dtype=torch.bool, device=dev)[1:].view(occ.shape)
    occ_bytes.copy_(occ)
    ms = {}
    for loads, maps in (("words", occ), ("bytes", occ_bytes)):
        got = extract_windows(maps, starts, pad)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"window (K2, {loads}) not bitwise equal to its plain form")
        ms[loads] = device_ms(lambda: extract_windows(maps, starts, pad), 50)
    print(f"window loads: {json.dumps({f'{k}_ms': v for k, v in ms.items()})}", flush=True)

    # The library yardstick: one advanced-indexing gather of the windows
    # from unfold views of the padded copy, which K2 no longer needs.
    padded = pad_occupancy(occ, pad)
    x0, y0 = clamp_starts(starts.to(torch.int64), padded.shape[1], padded.shape[2], WIN)
    views = padded.unfold(1, WIN_ROWS, 1).unfold(2, WIN, 1)
    env = torch.arange(N, device=dev)

    def library():
        return views[env, y0, x0]

    check(torch.equal(library().to(torch.uint8), want),
          "window (K2) not equal to slicing the padded copy")

    # The clamp on the card: starts outside the env path's range, on rooms
    # maps (word loads) and maze maps (21 columns: byte loads).
    clamped = 0
    for make_bank in (make_rooms_bank, make_maze_bank):
        maps = make_bank(256, device=dev)
        far_occ = maps.fetch(torch.randint(0, maps.num_maps, (1024,), generator=gen, device=dev))
        hp, wp = far_occ.shape[1] + 2 * pad, far_occ.shape[2] + 2 * pad
        far = torch.stack([torch.randint(-wp - 4, wp + 5, (1024,), generator=gen, device=dev),
                           torch.randint(-hp - 4, hp + 5, (1024,), generator=gen, device=dev)],
                          -1).to(torch.int32)
        far[:4] = torch.tensor([[-wp - 4, -hp - 4], [wp + 4, hp + 4], [-1, -1], [wp, 0]],
                               dtype=torch.int32, device=dev)
        got = extract_windows(far_occ, far, pad)
        torch.cuda.synchronize()
        check(torch.equal(got, plain_windows(far_occ, far, pad)),
              f"window (K2) on out-of-range starts, {tuple(far_occ.shape[1:])} maps: "
              "not bitwise equal to its plain form")
        clamped += far.shape[0]

    b_ms, b_by = window_bound(occ, starts, pad)
    k2 = {
        "name": "window", "route": "cuda", "source": "apx_torch/csrc/window.cu",
        "replaces": "apx/ops/window_pallas.py:70", "launches": None, "max_abs_err": 0.0,
        "ms": ms["words"],
        "plain_ms": device_ms(lambda: plain_windows(occ, starts, pad), 4),
        "bound_ms": b_ms, "bound_by": b_by,
        # Reads the padded copy (16 MB at N = 4096), which K2 does not.
        "library_ms": device_ms(library, 50),
        "shape": f"N={N} (32, 32) bool, pad {pad} -> (24, {WIN}) u8",
        "out_of_range_envs_checked": clamped,
    }

    per_kernel: dict = {}
    for name, cases in kernel_inputs(bank, gen, dev).items():
        kernel = getattr(raycast_cuda, name)
        typed = name == "raycast_typed"
        for occ_map, origin, targets in cases:
            starts, base = window_starts(origin, WIN, pad)
            win = extract_windows(occ_map, starts, pad).view(torch.bool)
            o, t = origin - base, targets - base[:, None]
            seg = seg_length(t - o[:, None])
            got = kernel(win, o, t, seg)
            want = raycast_grid(win, o, t, seg, geos_typing=typed)[0]
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"{name} on windows, R={t.shape[1]}: not bitwise equal (max |diff| {err})")
            r = t.shape[1]
            own = kernel(win, o, t)
            torch.cuda.synchronize()
            check(torch.equal(own.view(torch.int32), got.view(torch.int32)),
                  f"{name} on windows, R={r}, seg=None: not bitwise the explicit lengths' call")
            w_ms, w_by = bound(name, win, o, t)
            per_kernel.setdefault(name, {})[r] = {
                "ms": device_ms(lambda: kernel(win, o, t, seg), 50),
                "own_len_ms": device_ms(lambda: kernel(win, o, t), 50),
                "plain_ms": device_ms(lambda: raycast_grid(win, o, t, seg, geos_typing=typed), 4),
                "bound_ms": w_ms, "bound_by": w_by, "max_abs_err": err, "shape": "24x16"}
    return k2, per_kernel


def phase_chain(dev) -> dict:
    """K4: both layouts bitwise against the plain chain, then the study's
    ``measure()``; returns K4's kernels row."""
    from apx_torch.ops import issue_rate_study as study

    gen = torch.Generator(device=dev).manual_seed(4)
    rows, iters = 4096, 512  # measure()'s sizes
    for layout, lanes in study.LANES.items():
        odd = rows - 1 if layout == "wide" else 511
        for r, it in ((512, 1), (512, 5), (odd, 7), (odd, iters), (rows, iters)):
            args = [torch.rand((r, lanes), generator=gen, device=dev) for _ in range(5)]
            got = study.chain_cuda(*args, iters=it, layout=layout)
            want = study.chain_body(*args, it)
            torch.cuda.synchronize()
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"chain ({layout}, rows={r}, iters={it}) not bitwise equal to its plain form")
    clear_launches()
    res = study.measure(rows=rows, iters=iters, reps=20)
    launches = launched("K4")
    print(f"issue-rate study: {json.dumps(res)}", flush=True)
    check(launches == 2 * 21, f"chain launched {launches} times in measure(), not 42")
    by_layout = {}
    for layout, lanes in study.LANES.items():
        ops = rows * lanes * iters * study.CHAIN_OPS_PER_ELEM
        args = [torch.rand((rows, lanes), generator=gen, device=dev) for _ in range(5)]
        by_layout[layout] = {"ms": res[layout]["time_us"] / 1e3,
                             "plain_ms": device_ms(lambda: study.chain_body(*args, iters), 1),
                             "bound_ms": ops / FP32_ISSUE_PER_S * 1e3, "bound_by": "operations"}
    return {
        "name": "chain", "route": "cuda", "source": "apx_torch/csrc/issue_rate_study.cu",
        "replaces": "apx/ops/issue_rate_study.py:70", "launches": launches, "max_abs_err": 0.0,
        "ms": by_layout["wide"]["ms"],
        "plain_ms": by_layout["wide"]["plain_ms"],
        "bound_ms": by_layout["wide"]["bound_ms"], "bound_by": "operations",
        "library_ms": None,  # no PyTorch call runs the chain
        "shape": f"rows={rows} lanes=128 (wide) iters={iters}",
        "issue_penalty": res["issue_penalty"], "by_layout": by_layout,
    }


def lidar_path_launches(steps: int, window: bool = False) -> dict:
    """Kernel launches of a LIDARLocRooms-v0 path of ``steps`` NEXT_STEP
    steps from its reset. Dense: S once per step, R once at the reset and
    once per step (the merge's reset runs for every env), F2 once per
    step, no standalone K1 or F1. Under ``"pallas_window"``: K2 once per
    step and per reset, K1 3 fast per step and 1 typed per reset, F1 4 per
    step, F2 once per step, no S or R."""
    if window:
        return {"K2": 1 + 2 * steps, "K1.raycast_fast_launch": 3 * steps,
                "K1.raycast_typed_launch": 1 + steps, "F1": 4 * steps, "F2": steps, "S": 0, "R": 0}
    return {"S": steps, "R": 1 + steps, "F2": steps, "K1.raycast_fast_launch": 0,
            "K1.raycast_typed_launch": 0, "F1": 0}


def phase_main_path(dev, **overrides) -> dict:
    import apx_torch

    steps = 250
    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", num_envs=N, device=dev, **overrides)
    gen = torch.Generator(device=dev).manual_seed(0)
    zero_pred = torch.zeros((N, 2), device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    lidar_ok = torch.ones((), dtype=torch.bool, device=dev)
    r_lo = torch.full((), float("inf"), device=dev)
    r_hi = torch.full((), -float("inf"), device=dev)
    ends = torch.zeros(N, dtype=torch.int64, device=dev)

    torch.cuda.synchronize()
    clear_launches()
    t0 = time.perf_counter()
    obs, state, _ = venv.reset(params, gen)
    for _ in range(steps):
        act = torch.rand((N, 2), generator=gen, device=dev) * 2 - 1
        obs, state, reward, term, trunc, _ = venv.step(
            state, {"action": act, "prediction": zero_pred}, params, gen)
        for leaf in obs.values():
            finite &= torch.isfinite(leaf).all()
        lidar_ok &= ((obs["lidar"] >= 0) & (obs["lidar"] <= 1)).all()
        r_lo = torch.minimum(r_lo, reward.min())
        r_hi = torch.maximum(r_hi, reward.max())
        ends += (term | trunc).to(torch.int64)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_launches()
    path = "LIDAR main path" + (" (window)" if params.use_pallas_window else "")
    numerics = numerics_launches(path, steps, roots=False)
    n12 = {"N1": numerics["N1"], "N2": numerics["N2"]}
    check(n12 == {"N1": 1, "N2": 0},
          f"{path}: N1, N2 launched {n12}, expected N1 once (the reset's time obs), N2 never")

    check(bool(finite), "non-finite observation")
    check(bool(lidar_ok), "lidar outside [0, 1]")
    check(-2.9 <= float(r_lo) and float(r_hi) <= 0.1,
          f"rewards outside [-2.9, 0.1]: [{float(r_lo)}, {float(r_hi)}]")
    check(int(ends.min()) >= 2, f"an env crossed {int(ends.min())} episode ends (< 2)")
    shapes = {k: tuple(v.shape) for k, v in obs.items()}
    check(shapes == {"lidar": (N, 8), "odometry": (N, 2), "time_step": (N,),
                     "map": (N, 32, 32, 1)}, f"obs shapes {shapes}")
    want = lidar_path_launches(steps, window=params.use_pallas_window)
    got = launch_counts(want)
    check(got == want, f"{path} launches {got}, expected {want}")
    return {"steps": steps, "seconds": dt, "ms_per_step": 1e3 * dt / steps,
            "reward_range": [float(r_lo), float(r_hi)],
            "episode_ends_min": int(ends.min()), "terminations": int(ends.sum()),
            "launches": counts, "numerics_launches": numerics}


def phase_circle_square_main_path(dev) -> dict:
    import apx_torch

    steps = 51  # three 17-step LOCKSTEP cycles
    venv, params = apx_torch.make_vec("CircleSquare-v0", num_envs=N, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    zero_logits = torch.zeros((N, 2), device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    glimpse_ok = torch.ones((), dtype=torch.bool, device=dev)
    r_lo = torch.full((), float("inf"), device=dev)
    r_hi = torch.full((), -float("inf"), device=dev)
    resets = torch.zeros(N, dtype=torch.int64, device=dev)

    torch.cuda.synchronize()
    clear_launches()
    t0 = time.perf_counter()
    obs, state, _ = venv.reset(params, gen)
    for _ in range(steps):
        act = torch.rand((N, 2), generator=gen, device=dev) * 2 - 1
        obs, state, reward, term, trunc, _ = venv.step(
            state, {"action": act, "prediction": zero_logits}, params, gen)
        for leaf in obs.values():
            finite &= torch.isfinite(leaf).all()
        glimpse_ok &= ((obs["glimpse"] >= 0) & (obs["glimpse"] <= 1)).all()
        r_lo = torch.minimum(r_lo, reward.min())
        r_hi = torch.maximum(r_hi, reward.max())
        resets += (state.inner.time == 0).to(torch.int64)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_launches()
    numerics = numerics_launches("CircleSquare main path", steps)

    check(bool(finite), "non-finite observation")
    check(bool(glimpse_ok), "glimpse outside [0, 1]")
    check(-1.0015 <= float(r_lo) and float(r_hi) <= -1 + 1e-6,
          f"rewards outside [-1.0015, -1 + 1e-6]: [{float(r_lo)}, {float(r_hi)}]")
    check(int(resets.min()) >= 2, f"an env went through {int(resets.min())} resets (< 2)")
    shapes = {k: tuple(v.shape) for k, v in obs.items()}
    check(shapes == {"glimpse": (N, 5, 5, 1), "glimpse_pos": (N, 2), "time_step": (N,)},
          f"obs shapes {shapes}")
    check(launched("K3") == 1 + 2 * steps,
          f"glimpse launched {launched('K3')} times, not once for the reset and twice "
          f"per masked-merge step ({1 + 2 * steps})")
    return {"steps": steps, "seconds": dt, "ms_per_step": 1e3 * dt / steps,
            "reward_range": [float(r_lo), float(r_hi)], "resets_min": int(resets.min()),
            "launches": counts, "numerics_launches": numerics}


STATS_TOL = 1e-6  # float stats: softmax, and sums over the ring


def phase_card_vs_cpu(dev, env_id: str, n: int, steps: int, tol: dict, metrics: bool = False,
                      start_from_cpu: bool = False, build=None, **overrides) -> dict:
    """One trajectory of ``env_id`` (with parameter ``overrides``) on the
    card and on the CPU from the same actions, predictions and injected
    step and reset draws, drawn on the CPU in the vector step's order.
    ``start_from_cpu``: the card starts from the CPU's reset state instead
    of its own reset (the localization sweep's ties are compared apart).
    Leaves named in ``tol`` (obs keys, or "reward") are held to that
    absolute tolerance; every other leaf of the obs, states, rewards and
    dones must be bitwise equal. With ``metrics``, ``info["stats"]`` and
    the metrics buffers are compared too: ints, bools and NaN positions
    bitwise, floats within ``STATS_TOL``. ``build(n, device)``, where
    given, makes the vector env and params instead of ``make_vec``."""
    import apx_torch
    from apx_torch.core.env import tree_map
    from apx_torch.core.spaces import Logit
    from apx_torch.wrappers.metrics import MetricsState

    devices = (torch.device("cpu"), dev)
    runs = [build(n, d) if build is not None else
            apx_torch.make_vec(env_id, num_envs=n, device=d, metrics=metrics, **overrides)
            for d in devices]
    cpu_venv, cpu_params = runs[0]
    clear_launches()  # only the card's run counts: N1-N3 on this path
    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(7)
    space = cpu_venv.env.prediction_space(cpu_params)
    logits, width = isinstance(space, Logit), space.shape[-1]
    max_err = {k: 0.0 for k in (*tol, *(("stats",) if metrics else ()))}

    def to(tree, d):
        return tree_map(lambda x: x.to(d), tree)

    def leaves(tree):
        out = []
        tree_map(lambda x: out.append(x.cpu()), tree)
        return out

    def same(a, b, what):
        check(a.dtype == b.dtype and a.shape == b.shape, f"{what}: layout differs")
        if a.dtype == torch.float32:
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)), f"{what} differs")
        else:
            check(torch.equal(a, b), f"{what} differs")

    def close(a, b, key, what, limit):
        a, b = a.cpu(), b.cpu()
        check(torch.equal(torch.isnan(a), torch.isnan(b)), f"{what}: NaN positions differ")
        ok = ~torch.isnan(a)
        err = (a[ok] - b[ok]).abs().max().item() if bool(ok.any()) else 0.0
        max_err[key] = max(max_err[key], err)
        check(err <= limit, f"{what}: max |diff| {err} > {limit}")

    def stats_like(a, b, what):
        for x, y in zip(leaves(a), leaves(b), strict=True):
            if x.dtype == torch.float32:
                close(x, y, "stats", what, STATS_TOL)
            else:
                same(x, y, what)

    def split(state):
        """(leaves held bitwise, metrics buffers held as stats, the state's
        glimpse leaves, held as their obs)."""
        glimpses = {}
        vec = state.inner if isinstance(state, MetricsState) else state
        if hasattr(vec.inner, "target_glimpse"):  # the localization envs' carried glimpse
            glimpses["target_glimpse"] = vec.inner.target_glimpse
            vec = dataclasses.replace(vec, inner=dataclasses.replace(vec.inner,
                                                                     target_glimpse=None))
        if isinstance(state, MetricsState):
            return (vec, state.count, state.prev_done), state.buf, glimpses
        return vec, {}, glimpses

    drawn = cpu_venv.env.draw_reset(n, cpu_params, gen)
    if start_from_cpu:
        start = cpu_venv.reset(cpu_params, draws=drawn)[:2]
        carry = [start, to(start, dev)]
    else:
        carry = [venv.reset(params, draws=to(drawn, d))[:2]
                 for d, (venv, params) in zip(devices, runs)]
    for t in range(steps):
        act = torch.from_numpy(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
        pred = rng.standard_normal((n, width)) if logits else rng.uniform(-1, 1, (n, width))
        pred = torch.from_numpy(pred.astype(np.float32))
        step_drawn = cpu_venv.env.draw_step(n, cpu_params, gen)
        reset_drawn = cpu_venv.env.draw_reset(n, cpu_params, gen)
        outs = []
        for i, (d, (venv, params)) in enumerate(zip(devices, runs)):
            o, s, r, te, tr, info = venv.step(
                carry[i][1], {"action": act.to(d), "prediction": pred.to(d)}, params,
                reset_draws=to(reset_drawn, d), step_draws=to(step_drawn, d))
            carry[i] = (o, s)
            outs.append((o, s, r, te, tr, info))
        (oc, sc, rc, *dc, ic), (og, sg, rg, *dg, ig) = outs
        what = f"{env_id} step {t}"
        for k in oc:
            if k in tol:
                close(oc[k], og[k], k, f"{what} obs {k}", tol[k])
            else:
                same(oc[k], og[k].cpu(), f"{what} obs {k}")
        if "reward" in tol:
            close(rc, rg, "reward", f"{what} reward", tol["reward"])
        else:
            same(rc, rg.cpu(), f"{what} reward")
        (bc, fc, gc), (bg, fg, gg) = split(sc), split(sg)
        for a, b in zip(leaves((bc, *dc)), leaves((bg, *dg)), strict=True):
            same(a, b, f"{what} state or dones")
        for k in gc:
            close(gc[k], gg[k], k, f"{what} state {k}", tol[k])
        if metrics:
            stats_like(fc, fg, f"{what} metrics buffers")
            stats_like(ic["stats"], ig["stats"], f"{what} stats")
    return {"env": env_id, **overrides, "metrics": metrics, "num_envs": n, "steps": steps,
            "max_abs_err": max_err,
            "numerics_launches": numerics_launches(
                f"{env_id}{overrides or ''} card vs cpu, N={n}", steps,
                roots=None if build or env_id.startswith("LightDark")
                else metrics or not env_id.startswith("LIDAR")),
            "bitwise": sorted(set(oc) - set(tol)) + ["state", "dones"]
            + ([] if "reward" in tol else ["reward"])}


def phase_light_dark_main_path(dev) -> dict:
    import apx_torch

    steps = 200
    venv, params = apx_torch.make_vec("LightDark-v0", num_envs=N, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    zero_pred = torch.zeros((N, 2), device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    ranges_ok = torch.ones((), dtype=torch.bool, device=dev)
    r_lo = torch.full((), float("inf"), device=dev)
    r_hi = torch.full((), -float("inf"), device=dev)
    ends = torch.zeros(N, dtype=torch.int64, device=dev)

    torch.cuda.synchronize()
    clear_launches()
    t0 = time.perf_counter()
    obs, state, _ = venv.reset(params, gen)
    for _ in range(steps):
        act = torch.rand((N, 2), generator=gen, device=dev) * 2 - 1
        obs, state, reward, term, trunc, _ = venv.step(
            state, {"action": act, "prediction": zero_pred}, params, gen)
        for leaf in obs.values():
            finite &= torch.isfinite(leaf).all()
        ranges_ok &= (obs["noisy_position"].abs() <= 2).all() & (obs["time_step"].abs() <= 1).all()
        r_lo = torch.minimum(r_lo, reward.min())
        r_hi = torch.maximum(r_hi, reward.max())
        ends += (term | trunc).to(torch.int64)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_launches()
    numerics = numerics_launches("LightDark main path", steps, roots=None)

    want = {"L.light_dark_step_launch": steps, "L.light_dark_reset_launch": 1 + steps,
            "F2": steps}
    got = launch_counts(want)
    check(got == want, f"LightDark main path: launches {got}, expected {want}")
    check(numerics["N2"] == numerics["N3"] == 0,
          f"LightDark main path: N2 or N3 launched beside L ({numerics})")
    check(bool(finite), "non-finite observation")
    check(bool(ranges_ok), "noisy_position outside [-2, 2] or time_step outside [-1, 1]")
    check(-2.002 <= float(r_lo) and float(r_hi) <= 1.0,
          f"rewards outside [-2.002, 1]: [{float(r_lo)}, {float(r_hi)}]")
    check(int(ends.min()) >= 3, f"an env crossed {int(ends.min())} episode ends (< 3)")
    shapes = {k: tuple(v.shape) for k, v in obs.items()}
    check(shapes == {"noisy_position": (N, 2), "time_step": (N,)}, f"obs shapes {shapes}")
    return {"steps": steps, "seconds": dt, "ms_per_step": 1e3 * dt / steps,
            "reward_range": [float(r_lo), float(r_hi)], "episode_ends_min": int(ends.min()),
            "launches": counts, "numerics_launches": numerics}


def phase_sparse_metrics_path(dev, env_id: str, steps: int) -> dict:
    """A ``-sparse`` id with ``metrics=True`` at N = 4096, zero predictions:
    the kernels' launches, the weight, the reward and the stats (phase 13)."""
    import apx_torch
    from apx_torch.wrappers.metrics import ClassificationMetrics

    venv, params = apx_torch.make_vec(env_id, num_envs=N, device=dev, metrics=True)
    classification = isinstance(venv, ClassificationMetrics)
    gen = torch.Generator(device=dev).manual_seed(0)
    k = venv.env.prediction_space(params).shape[-1]
    zero_pred = torch.zeros((N, k), device=dev)
    ok = {name: torch.ones((), dtype=torch.bool, device=dev)
          for name in ("weight", "reward_off", "finite_where_done", "lengths", "half")}
    err = torch.zeros((), device=dev)
    ends = torch.zeros(N, dtype=torch.int64, device=dev)

    torch.cuda.synchronize()
    clear_launches()
    t0 = time.perf_counter()
    obs, state, _ = venv.reset(params, gen)
    for _ in range(steps):
        prev_done = state.prev_done
        act = torch.rand((N, 2), generator=gen, device=dev) * 2 - 1
        obs, state, reward, term, trunc, info = venv.step(
            state, {"action": act, "prediction": zero_pred}, params, gen)
        pred_info = info["prediction"]
        weight = pred_info["target"]["weight"]
        done = term | trunc
        live = prev_done.logical_not()
        ok["weight"] &= (weight == term.to(torch.float32))[live].all()
        off = (weight == 0) | prev_done
        ok["reward_off"] &= (reward == info["base_reward"])[off].all()
        want = info["base_reward"] - weight * pred_info["loss"]
        err = torch.maximum(err, torch.where(off, 0.0, (reward - want).abs()).max())
        scalar = info["stats"]["scalar"]
        for name, v in scalar.items():
            if not name.startswith("_") and v.dtype == torch.float32:
                ok["finite_where_done"] &= torch.equal(torch.isfinite(v), done)
        inner = state.inner.inner  # the episode's step count: TimeLimit's t or the image env's time
        steps_done = inner.time if classification else inner.t
        ok["lengths"] &= (info["stats"]["vector_lengths"] == steps_done)[done].all()
        if classification:
            half = (scalar["avg_correct_label_prob"] - 0.5).abs() <= 1e-6
            ok["half"] &= half[done].all()
        ends += done.to(torch.int64)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_launches()
    numerics = numerics_launches(f"{env_id} metrics path", steps)

    for name, flag in ok.items():
        check(bool(flag), f"{env_id} metrics path: check {name!r} failed")
    check(float(err) <= 1e-6, f"{env_id}: reward vs base - weight * loss |diff| {float(err)}")
    check(int(ends.min()) >= 2, f"{env_id}: an env crossed {int(ends.min())} episode ends (< 2)")
    if classification:
        want_launches = {"K3": 1 + 2 * steps}
    else:
        # the -sparse loss takes the plain merge (no F2)
        want_launches = {**lidar_path_launches(steps), "F2": 0}
    got = launch_counts(want_launches)
    check(got == want_launches, f"{env_id} launches {got}, expected {want_launches}")
    return {"env": env_id, "metrics": True, "steps": steps, "seconds": dt,
            "ms_per_step": 1e3 * dt / steps, "reward_err_max": float(err),
            "episode_ends_min": int(ends.min()), "launches": counts,
            "numerics_launches": numerics}


SCORE_TOL = 3e-6  # uniqueness scores at TinyImageNet's geometry, card vs CPU
TOP_K = 10


def phase_tin_loc_main_path(dev) -> dict:
    """``make_vec("TinyImageNetLoc-v0", 4096)`` (the registry's 8192-image
    synthetic bank): the explicit reset, which runs the unique-target
    sweep, timed and its peak memory read; then 51 steps (three 17-step
    LOCKSTEP cycles) of uniform actions with zero predictions."""
    import apx_torch

    steps = 51
    venv, params = apx_torch.make_vec("TinyImageNetLoc-v0", num_envs=N, device=dev)
    print(f"tin_loc bank: {params.dataset.bank_kind}, {params.dataset.length} images of "
          f"{params.dataset.image_shape}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    zero_pred = torch.zeros((N, 2), device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    glimpse_ok = torch.ones((), dtype=torch.bool, device=dev)
    r_lo = torch.full((), float("inf"), device=dev)
    r_hi = torch.full((), -float("inf"), device=dev)
    resets = torch.zeros(N, dtype=torch.int64, device=dev)

    venv.reset(params, gen)  # warm up: builds the kernels' launch path and cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    clear_launches()
    t0 = time.perf_counter()
    obs, state, _ = venv.reset(params, gen)
    torch.cuda.synchronize()
    reset_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    reset_launches = launched("K3")
    t0 = time.perf_counter()
    for _ in range(steps):
        act = torch.rand((N, 2), generator=gen, device=dev) * 2 - 1
        obs, state, reward, term, trunc, _ = venv.step(
            state, {"action": act, "prediction": zero_pred}, params, gen)
        for leaf in obs.values():
            finite &= torch.isfinite(leaf).all()
        for key in ("glimpse", "target_glimpse"):
            glimpse_ok &= ((obs[key] >= 0) & (obs[key] <= 1)).all()
        r_lo = torch.minimum(r_lo, reward.min())
        r_hi = torch.maximum(r_hi, reward.max())
        resets += (state.inner.perception.time == 0).to(torch.int64)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_launches()
    numerics = numerics_launches("TinyImageNetLoc main path", steps)

    check(bool(finite), "non-finite observation")
    check(bool(glimpse_ok), "glimpse or target_glimpse outside [0, 1]")
    check(-3.0015 <= float(r_lo) and float(r_hi) <= 0.0,
          f"rewards outside [-3.0015, 0]: [{float(r_lo)}, {float(r_hi)}]")
    check(int(resets.min()) >= 2, f"an env went through {int(resets.min())} resets (< 2)")
    shapes = {k: tuple(v.shape) for k, v in obs.items()}
    check(shapes == {"glimpse": (N, 10, 10, 3), "glimpse_pos": (N, 2), "time_step": (N,),
                     "target_glimpse": (N, 10, 10, 3)}, f"obs shapes {shapes}")
    # The explicit reset: the obs and the target glimpse; a masked-merge
    # step: the step's obs, and the autoreset's obs and target glimpse.
    check(reset_launches == 2, f"glimpse launched {reset_launches} times in the reset, not 2")
    check(launched("K3") == 2 + 3 * steps,
          f"glimpse launched {launched('K3')} times, not 2 + 3 per step ({2 + 3 * steps})")
    return {"steps": steps, "seconds": dt, "ms_per_step": 1e3 * dt / steps,
            "reset_ms": reset_ms, "reset_peak_bytes": peak,
            "reset_peak_above_start_bytes": peak - start_bytes,
            "reward_range": [float(r_lo), float(r_hi)], "resets_min": int(resets.min()),
            "launches": counts, "numerics_launches": numerics}


def ranking_gap(u_ref: np.ndarray, u_got: np.ndarray) -> float | None:
    """The smallest gap between distinct ``u_ref`` scores among its first
    TOP_K + 1 when those scores decide the top-k of ``u_got`` too (every
    such gap wider than 2 SCORE_TOL, no exact tie across the k-th place,
    ``u_ref``'s exact ties within the top k exact in ``u_got``), else None."""
    order = np.argsort(-u_ref, kind="stable")[:TOP_K + 1]
    srt = u_ref[order]
    gaps = srt[:-1] - srt[1:]
    ties_hold = gaps[-1] > 0 and all(u_got[order[j]] == u_got[order[j + 1]]
                                     for j in np.flatnonzero(gaps == 0))
    if not ties_hold or gaps[gaps > 0].min() <= 2 * SCORE_TOL:
        return None
    return float(gaps[gaps > 0].min())


def phase_sweep_card_vs_cpu(dev, n: int = 64) -> dict:
    """The unique-target sweep of ``TinyImageNetLoc-v0`` on the card and on
    the CPU from the same injected reset draws: scores within SCORE_TOL;
    the top-k and the explicit reset's targets equal on every env whose
    ranking the scores decide (each gap between distinct CPU scores among
    the first k + 1 wider than 2 SCORE_TOL, no exact tie across the k-th
    place, the CPU's exact ties within the top k exact on the card)."""
    import apx_torch
    from apx_torch.envs.image_perception import ImagePerceptionEngine as engine

    runs = {d: apx_torch.make_vec("TinyImageNetLoc-v0", num_envs=n, device=d)
            for d in ("cpu", dev)}
    cpu_venv, cpu_params = runs["cpu"]
    drawn = cpu_venv.env.draw_reset(n, cpu_params, torch.Generator().manual_seed(7))
    _, s_cpu, _ = cpu_venv.reset(cpu_params, draws=drawn)
    dev_venv, dev_params = runs[dev]
    _, s_dev, _ = dev_venv.reset(dev_params, draws={k: v.to(dev) for k, v in drawn.items()})
    images = s_cpu.inner.perception.image
    u_cpu = engine.uniqueness(images, cpu_params).numpy()
    u_dev = engine.uniqueness(images.to(dev), dev_params).cpu().numpy()
    err = float(np.abs(u_cpu - u_dev).max())
    check(err <= SCORE_TOL, f"uniqueness card vs cpu: max |diff| {err} > {SCORE_TOL}")
    top_cpu = np.argsort(-u_cpu, axis=-1, kind="stable")[:, :TOP_K]
    top_dev = engine.unique_target_top_k(images.to(dev), dev_params).cpu().numpy()
    compared, low = 0, float("inf")
    for i in range(n):
        gap = ranking_gap(u_cpu[i], u_dev[i])
        if gap is None:
            continue
        compared += 1
        low = min(low, gap)
        check(np.array_equal(top_cpu[i], top_dev[i]), f"top-k of env {i} differs card vs cpu")
        check(torch.equal(s_cpu.inner.target[i], s_dev.inner.target[i].cpu()),
              f"target of env {i} differs card vs cpu")
    check(compared > 0, "no env's ranking was decided")
    return {"env": "TinyImageNetLoc-v0", "num_envs": n, "score_max_abs_err": err,
            "score_tol": SCORE_TOL, "envs_compared": compared, "smallest_gap": low}


ROOT = Path(__file__).resolve().parent
SHARDED_STEPS = 250  # the LIDAR main path's
EPISODIC_STEPS = 51  # three 17-step CircleSquare cycles
PHASE_TIMEOUT_S = 600


def _spawn(cmds: list[list[str]], env_extra: dict) -> list[str]:
    """Run the commands at once, each in a process of its own, from the
    repo root; kill any still running after PHASE_TIMEOUT_S. Returns their
    standard outputs; a nonzero exit raises with its output."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), **env_extra}
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cmd in cmds]
    deadline = time.monotonic() + PHASE_TIMEOUT_S
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        check(p.returncode == 0, f"{' '.join(cmd[2:])} exited {p.returncode}:\n{out[-3000:]}\n"
                                 f"{err[-3000:]}")
    return [out for out, _ in outs]


def _tagged(out: str, tag: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith(tag)]
    check(len(lines) == 1, f"expected one {tag!r} line, got {len(lines)}")
    return json.loads(lines[0][len(tag):])


def path_launches(env_id: str, steps: int) -> dict:
    """Kernel launches of one rollout of ``steps`` steps from its reset: the
    LIDAR path's ``lidar_path_launches``; an episodic CircleSquare step
    (DISABLED or boundary) and the reset one glimpse each."""
    if env_id.startswith("LIDAR"):
        return lidar_path_launches(steps)
    return {"K3": 1 + steps}


def phase_sharded_rollout(env_id: str, world: int, backend: str, steps: int,
                          period: int | None = None) -> dict:
    """``world`` ranks of ``python -m apx_torch.distrib.selftest`` on cuda:0
    over ``backend``, N = 4096 in all: each rank's block of the final state
    bitwise the one-process rollout's (rank 0 runs it on the card with the
    same seed), equal done counts, mean rewards within rtol 1e-6, and each
    rank's and the solo run's kernel launches ``path_launches``, N1 among
    them (the report counts every kernel: ``ops._launch.launches``)."""
    store = tempfile.mkdtemp(prefix="apx_store_")
    try:
        extra = ["--episodic-period", str(period)] if period is not None else []
        outs = _spawn([[sys.executable, "-m", "apx_torch.distrib.selftest", "--rank", str(r),
                        "--world", str(world), "--init", f"file://{store}/store",
                        "--backend", backend, "--device", "cuda:0", "--env", env_id,
                        "--num-envs", str(N), "--steps", str(steps), *extra]
                       for r in range(world)],
                      {"NCCL_SOCKET_IFNAME": "lo"} if backend == "nccl" else {})
    finally:
        shutil.rmtree(store, ignore_errors=True)
    ranks = [_tagged(out, "SELFTEST ") for out in outs]
    solo = ranks[0]["solo"]
    want = path_launches(env_id, steps)
    what = f"{env_id} sharded over {world} {backend} rank(s)"
    for who, report in (("the solo run", solo["launches"]),
                        *((f"rank {r}", out["launches"]) for r, out in enumerate(ranks))):
        check(launch_counts(want, report) == want and launched("N1", report) > 0,
              f"{what}: {who} launched {report}, expected {want} and N1")
    for r, out in enumerate(ranks):
        check(out["rank"] == r and out["backend"] == backend and out["device"] == "cuda:0",
              f"{what}: rank {r} ran as {out['rank']} on {out['device']} over {out['backend']}")
        check(out["digest"] == solo["digests"][r],
              f"{what}: rank {r}'s block is not bitwise the solo run's")
        check(out["done_count"] == solo["done_count"],
              f"{what}: done count {out['done_count']} vs solo {solo['done_count']}")
        rel = abs(out["mean_reward"] - solo["mean_reward"]) / abs(solo["mean_reward"])
        check(rel <= 1e-6, f"{what}: mean reward {out['mean_reward']} vs solo "
                           f"{solo['mean_reward']} (rel {rel})")
    return {"env": env_id, "world_size": world, "backend": backend, "num_envs": N,
            "steps": steps, "episodic_period": period,
            "ranks": [{k: out[k] for k in ("rank", "block", "seconds", "launches",
                                             "mean_reward", "done_count")}
                      | {"ms_per_step": 1e3 * out["seconds"] / steps} for out in ranks],
            "solo": {k: solo[k] for k in ("seconds", "launches", "mean_reward", "done_count")}
            | {"ms_per_step": 1e3 * solo["seconds"] / steps}}


def _bytes(tree) -> list[torch.Tensor]:
    return [x.detach().cpu().reshape(-1).view(torch.uint8) for x in _leaves_of(tree)]


def _same(a, b, what: str) -> None:
    la, lb = _bytes(a), _bytes(b)
    check(len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb)),
          f"{what}: not bitwise equal")


def phase_checkpoint(dev) -> dict:
    """Checkpoint resume on the card: save after k steps (obs, state and the
    generator's state), continue m steps; restore into a fresh state made on
    the card and continue m steps: bitwise the uninterrupted run. Then the
    card checkpoint restored onto a CPU ``like`` (leaves on the CPU, bitwise)
    and that state saved and restored onto the card again, bitwise."""
    import apx_torch
    from apx_torch.utils.checkpoint import restore_state, save_state

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for env_id, metrics, k, m in (("LIDARLocRooms-v0", False, 60, 50),
                                      ("CircleSquare-v0", True, 10, 30)):
            def steps(venv, params, obs, state, g, count):
                out = []
                pred = venv.env.prediction_space(params).shape[-1]
                for _ in range(count):
                    act = {"action": torch.rand((N, 2), generator=g, device=dev) * 2 - 1,
                           "prediction": torch.randn((N, pred), generator=g, device=dev)}
                    obs, state, *rest = venv.step(state, act, params, g)
                    out.append((obs, state, *rest))
                return out

            venv, params = apx_torch.make_vec(env_id, N, device=dev, metrics=metrics)
            g = torch.Generator(dev).manual_seed(11)
            obs, state, _ = venv.reset(params, g)
            obs, state = steps(venv, params, obs, state, g, k)[-1][:2]
            path = f"{tmp}/{env_id}.pt"
            t0 = time.perf_counter()
            save_state(path, {"obs": obs, "state": state, "generator": g.get_state()})
            save_s = time.perf_counter() - t0
            want = steps(venv, params, obs, state, g, m)

            g2 = torch.Generator(dev).manual_seed(12)
            obs2, like, _ = venv.reset(params, g2)
            t0 = time.perf_counter()
            got = restore_state(path, {"obs": obs2, "state": like, "generator": g2.get_state()})
            restore_s = time.perf_counter() - t0
            g2.set_state(got["generator"])
            _same(want, steps(venv, params, got["obs"], got["state"], g2, m),
                  f"{env_id}: resumed run on the card")

            cpu_venv, cpu_params = apx_torch.make_vec(env_id, N, device="cpu", metrics=metrics)
            cpu_obs, cpu_like, _ = cpu_venv.reset(cpu_params, torch.Generator().manual_seed(0))
            on_cpu = restore_state(path, {"obs": cpu_obs, "state": cpu_like,
                                          "generator": g2.get_state()})
            devices = {x.device.type for x in _leaves_of(on_cpu)}
            check(devices == {"cpu"}, f"{env_id}: restored onto a CPU like, leaves on {devices}")
            _same(on_cpu["state"], state, f"{env_id}: card checkpoint restored on the CPU")
            back = f"{tmp}/{env_id}.cpu.pt"
            save_state(back, on_cpu)
            again = restore_state(back, {"obs": obs2, "state": like, "generator": g2.get_state()})
            check({x.device.type for x in _leaves_of(again["state"])} == {"cuda"},
                  f"{env_id}: CPU checkpoint restored onto a card like left the card")
            _same(again["state"], state, f"{env_id}: CPU checkpoint restored on the card")
            res[env_id] = {"metrics": metrics, "k": k, "m": m, "bytes": os.path.getsize(path),
                           "save_s": save_s, "restore_s": restore_s}
    return res


def _leaves_of(tree) -> list[torch.Tensor]:
    from apx_torch.core.env import tree_map

    out = []
    tree_map(out.append, tree)
    return out


SLAB_SHAPE = (100_000, 64, 64, 3)  # TinyImageNet's banked size, 1.23 GB of uint8
ROTATOR_CHUNKS = 1500  # tin_loc graph chunks (17 steps each) replayed while a slab stages


def host_slab(k: int) -> np.ndarray:
    """A 1.23 GB uint8 slab: a seeded random 1024-image block, repeated."""
    block = np.random.default_rng(100 + k).integers(0, 256, (1024, *SLAB_SHAPE[1:]),
                                                    dtype=np.uint8)
    return np.resize(block, SLAB_SHAPE)


def phase_bank_rotator(dev) -> dict:
    """BankRotator with 1.23 GB slabs: each swap bitwise its host slab; the
    H2D rate of the first slab's copies (nothing else running) and of the
    second's, staged while the ``tin_loc`` graph loop (N = 4096) replays;
    that loop's ms per step from CUDA events per 17-step chunk, before the
    rotator exists and, placed on the device timeline by the copies'
    events, in the chunks that ran wholly during the second copy and those
    wholly outside it."""
    from apx_torch.bench import _draws, _loop, graph_chunk
    from apx_torch.data.stream import BankRotator

    slabs = [host_slab(0), host_slab(1)]
    nbytes = slabs[0].nbytes
    lp = _loop("tin_loc", N, dev, bank_points=TIN_BANK)
    g = torch.Generator(dev).manual_seed(0)
    obs, state, _ = lp.venv.reset(lp.params, g)
    rsum = torch.zeros((), device=dev)
    draws = _draws(lp, 4 * lp.chunk, g)
    replay = graph_chunk(lp, obs, state, draws, rsum)

    def run_chunks(count: int):
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
        ends = []
        for c in range(count):
            replay(draws, c % 4)
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        torch.cuda.synchronize()
        t = [ref.elapsed_time(e) for e in ends]
        return ref, [(a, b) for a, b in zip([0.0] + t[:-1], t)]

    def ms_per_step(spans) -> float:
        return float(np.median([b - a for a, b in spans])) / lp.chunk

    run_chunks(20)
    _, before = run_chunks(300)

    remaining = iter(slabs)  # a third load raises StopIteration, for a third swap
    rot = BankRotator(lambda: next(remaining), device=dev)
    try:
        t0 = time.perf_counter()
        first = rot.swap()
        first_s = time.perf_counter() - t0
        c0, c1 = rot.last_copy_events
        c1.synchronize()
        alone_ms = c0.elapsed_time(c1)
        # At once: the thread pins and copies slab 1 while the chunks run.
        ref, spans = run_chunks(ROTATOR_CHUNKS)
        second = rot.swap()
        c0, c1 = rot.last_copy_events
        c1.synchronize()
        copy = (ref.elapsed_time(c0), ref.elapsed_time(c1))
        for k, got in enumerate((first, second)):
            check(got.dtype == torch.uint8 and tuple(got.shape) == SLAB_SHAPE,
                  f"swap {k} returned {got.dtype} {tuple(got.shape)}")
            check(np.array_equal(got.cpu().numpy(), slabs[k]),
                  f"slab {k} is not bitwise its host slab")
    finally:
        rot.close()
    inside = [sp for sp in spans if sp[0] >= copy[0] and sp[1] <= copy[1]]
    outside = [sp for sp in spans if sp[1] <= copy[0] or sp[0] >= copy[1]]
    check(len(inside) > 0, f"the second copy ({copy[1] - copy[0]:.2f} ms at "
                           f"{copy[0]:.1f} ms) overlapped no whole chunk of the "
                           f"{spans[-1][1]:.1f} ms loop")
    del first, second
    torch.cuda.empty_cache()
    return {"slab_bytes": nbytes, "first_swap_s": first_s,
            "h2d_alone_ms": alone_ms, "h2d_alone_gb_per_s": nbytes / alone_ms / 1e6,
            "h2d_during_loop_ms": copy[1] - copy[0],
            "h2d_during_loop_gb_per_s": nbytes / (copy[1] - copy[0]) / 1e6,
            "tin_loc_graph_ms_per_step_before": ms_per_step(before),
            "tin_loc_graph_ms_per_step_copy_in_flight": ms_per_step(inside),
            "tin_loc_graph_ms_per_step_outside_copy": ms_per_step(outside),
            "chunks_during_copy": len(inside), "chunks_outside_copy": len(outside),
            "chunk_steps": lp.chunk}


def phase_native_bank(dev) -> dict:
    """The native C++ bank generator built on this machine (g++, into
    apx_torch/_build/): rooms (32x32) and maze (21x21) banks of 256 maps on
    the card equal to the same banks built on the CPU, and ``fetch_halves``
    on the card bitwise its CPU result for (N,) and (N, 3) indices."""
    from apx_torch.data import native
    from apx_torch.data.floor_map import make_maze_bank, make_rooms_bank

    t0 = time.perf_counter()
    check(native.native_available(), f"{native.SRC} did not build")
    res = {"build_or_load_s": time.perf_counter() - t0}
    gen = torch.Generator().manual_seed(9)
    for kind, mk in (("rooms", make_rooms_bank), ("maze", make_maze_bank)):
        t0 = time.perf_counter()
        bank = mk(256, backend="native", device=dev)
        res[f"{kind}_bank_s"] = time.perf_counter() - t0
        cpu = mk(256, backend="native", device="cpu")
        for f in ("maps", "indices", "free_counts", "row_words", "free_cells"):
            check(torch.equal(getattr(bank, f).cpu(), getattr(cpu, f)),
                  f"native {kind} bank: {f} differs card vs cpu")
        for shape in ((N,), (N, 3)):
            idx = torch.randint(0, 256, shape, generator=gen)
            got = bank.fetch_halves(idx.to(dev))
            check(got.dtype == torch.int32 and torch.equal(got.cpu(), cpu.fetch_halves(idx)),
                  f"native {kind} bank: fetch_halves{shape} differs card vs cpu")
    return res


def phase_sharded_bench(env: str, nproc: int, backend: str) -> dict:
    """``torchrun --standalone --nproc_per_node=nproc -m apx_torch.bench
    --distributed`` (rank 0's line: the sharded and the plain rates)."""
    device = "cuda:0" if nproc > 1 else "cuda"
    out = _spawn([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                   f"--nproc_per_node={nproc}", "-m", "apx_torch.bench", "--distributed",
                   "--env", env, "--backend", backend, "--device", device]],
                 {"NCCL_SOCKET_IFNAME": "lo"})[0]
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(len(lines) == 1, f"sharded bench {env}: {len(lines)} result lines")
    res = json.loads(lines[0])
    check(res["world_size"] == nproc and res["backend"] == backend,
          f"sharded bench ran {res['world_size']} ranks over {res['backend']}")
    return res


COMPAT_N = 64
COMPAT_FLOAT_TOL = 1e-6  # image ids: glimpses (K3 against the plain form), stats


def _np_same(a, b, what: str, tol: float | None, err: dict) -> None:
    """Host trees equal: same keys, dtypes and shapes; floats bitwise, or
    within ``tol`` with NaNs in the same places; object arrays (the vector
    stats' per-env series) element by element."""
    if isinstance(a, dict):
        check(isinstance(b, dict) and set(a) == set(b), f"{what}: keys differ")
        for k in a:
            _np_same(a[k], b[k], f"{what}/{k}", tol, err)
        return
    a, b = np.asarray(a), np.asarray(b)
    check(a.dtype == b.dtype and a.shape == b.shape,
          f"{what}: {a.dtype}{a.shape} against {b.dtype}{b.shape}")
    if a.dtype == object:
        for i, (x, y) in enumerate(zip(a, b)):
            _np_same(np.asarray(x, np.float32), np.asarray(y, np.float32), f"{what}[{i}]",
                     tol, err)
        return
    if a.dtype.kind == "f" and tol is not None:
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{what}: NaN positions differ")
        ok = ~np.isnan(a)
        d = float(np.max(np.abs(a[ok].astype(np.float64) - b[ok]))) if ok.any() else 0.0
        err["max_abs_err"] = max(err["max_abs_err"], d)
        check(d <= tol, f"{what}: max |diff| {d} > {tol}")
    elif a.dtype.kind == "f":
        check(np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")),
              f"{what}: not bitwise equal")
    else:
        check(np.array_equal(a, b), f"{what}: not equal")


def phase_compat_card_vs_cpu(dev, env_id: str, n: int, steps: int, tol: float | None,
                             **overrides) -> dict:
    """The adapter core on the card and on the CPU in reference mode, seed
    0, from the same numpy actions, with the gymnasium-free log stats;
    every output held bitwise, or (``tol``) floats within ``tol``. Returns
    the card run's kernel launches (counts set to 0 just before it) and the
    number of NEXT_STEP merge steps it ran."""
    from apx_torch.compat import make_core
    from apx_torch.compat.stats import VectorClassificationStats, VectorRegressionStats
    from apx_torch.core.spaces import Logit

    cores = [make_core(env_id, n, device=d, rng="reference", **overrides)
             for d in (torch.device("cpu"), dev)]
    space = cores[0].env.prediction_space(cores[0].params)
    logits, width = isinstance(space, Logit), space.shape[-1]
    stats = [VectorClassificationStats(n, width) if logits else VectorRegressionStats(n)
             for _ in cores]
    rng = np.random.default_rng(0)
    err = {"max_abs_err": 0.0}
    merges = 0
    prev_done = False  # any env of the card's run done at the previous step
    t0 = time.perf_counter()
    outs = [cores[0].reset(seed=0)]
    torch.cuda.synchronize()
    clear_launches()
    outs.append(cores[1].reset(seed=0))
    for k, x, y in zip(("obs", "info"), *outs):
        _np_same(x, y, f"{env_id} reset {k}", tol, err)
    for t in range(steps):
        act = {"action": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
               "prediction": (rng.standard_normal((n, width)) if logits
                              else rng.uniform(-1, 1, (n, width))).astype(np.float32)}
        merges += int(cores[1].autoreset == "next_step" and prev_done)
        outs = []
        for core, st in zip(cores, stats):
            obs, reward, term, trunc, info = core.step(act)
            outs.append((obs, reward, term, trunc, st.update(act, term, trunc, info)))
        for k, x, y in zip(("obs", "reward", "terminated", "truncated", "info"), *outs):
            _np_same(x, y, f"{env_id} step {t} {k}", tol, err)
        prev_done = bool(np.any(outs[1][2] | outs[1][3]))
    torch.cuda.synchronize()
    counts = kernel_launches()
    numerics = numerics_launches(f"{env_id}{overrides or ''} compat core, N={n}", steps,
                                 roots=None if env_id.startswith("LightDark")
                                 else not env_id.startswith("LIDAR"))
    ends = int(sum(np.asarray(outs[1][2]) | np.asarray(outs[1][3])))
    return {"env": env_id, **overrides, "num_envs": n, "steps": steps, "merge_steps": merges,
            "seconds": time.perf_counter() - t0, "launches": counts,
            "numerics_launches": numerics,
            "compared": "bitwise" if tol is None else f"ints and bools bitwise, floats {tol}",
            "last_step_ends": ends, **err}


def phase_compat(dev) -> tuple[list[dict], dict]:
    """Phase 24: the compat paths card against CPU, each kernel's launches
    held to the prediction from the code. Returns (results, launches by
    kernel name: a list of {"env", "launches"} per path)."""
    cases = [
        ("LIDARLocRooms-v0", COMPAT_N, 210, None, {}),
        ("LIDARLocRooms-v0", COMPAT_N, 210, None, {"raycast_backend": "pallas_window"}),
        ("LightDark-v0", COMPAT_N, 210, None, {}),
        ("CircleSquare-v0", COMPAT_N, 40, COMPAT_FLOAT_TOL, {}),
        ("TinyImageNetLoc-v0", 4, 10, COMPAT_FLOAT_TOL, {}),
    ]
    results, by_kernel = [], {}
    for env_id, n, steps, tol, kw in cases:
        res = phase_compat_card_vs_cpu(dev, env_id, n, steps, tol, **kw)
        got, m = res["launches"], res["merge_steps"]
        if env_id.startswith("LIDAR"):
            # Reference-mode resets build the state from host maps and scan
            # with K1 typed (``compat.builders``); the steps are the env's.
            want = {"K1.raycast_typed_launch": 1 + m, "R": 0}
            if kw:
                want.update({"K1.raycast_fast_launch": 3 * steps, "F1": 4 * steps, "S": 0,
                             "K2": steps + 1 + m})
            else:
                want.update({"K1.raycast_fast_launch": 0, "F1": 0, "S": steps})
            check(m == 2, f"{env_id}: {m} NEXT_STEP merge steps, expected the two boundaries")
        elif env_id == "CircleSquare-v0":
            want = {"K3": 1 + steps}
        elif env_id == "TinyImageNetLoc-v0":
            want = {"K3": 2 + steps}
        else:
            want = {}
        check(all(got[k] == v for k, v in want.items()),
              f"{env_id} {kw}: launches {got}, expected {want}")
        res["launches_expected"] = want
        for k in want:
            by_kernel.setdefault(k, []).append({"env": env_id, **kw, "num_envs": n,
                                                "steps": steps, "launches": got[k]})
        results.append(res)
    return results, by_kernel


PM_N = 4096
PM_STEPS = 32
PM_UNIQUE_CPU_ENVS = 64  # the CPU's score sweep is ~0.1 s per env


def phase_perception_module(dev) -> dict:
    """Phase 26: the perception module on the card against the CPU."""
    import copy

    from apx_torch.compat.dataset_classes import CircleSquareDataset
    from apx_torch.compat.perception_module import ImagePerceptionConfig, ImagePerceptionModule

    cfg = ImagePerceptionConfig(dataset=CircleSquareDataset(), prefetch=False)
    card = ImagePerceptionModule(PM_N, cfg, device=dev)
    cpu = ImagePerceptionModule(PM_N, cfg, device="cpu")
    card.seed(0)
    cpu.seed(0)
    t0 = time.perf_counter()
    obs_c, info_c = card.reset()
    reset_ms = 1e3 * (time.perf_counter() - t0)
    obs_u, info_u = cpu.reset()
    _np_same({"obs": obs_c, "info": info_c, "labels": card.current_labels},
             {"obs": obs_u, "info": info_u, "labels": cpu.current_labels}, "reset", None, {})
    keys = ("obs", "reward", "terminated", "truncated", "info")
    rng = np.random.default_rng(1)
    card_s = cpu_s = 0.0
    ends = 0
    for t in range(PM_STEPS):
        act = rng.uniform(-1.5, 1.5, (PM_N, 2))
        quality = rng.uniform(0, 1, PM_N)
        t0 = time.perf_counter()
        out_c = card.step(act, quality)  # numpy out: ends on the copy
        t1 = time.perf_counter()
        out_u = cpu.step(act, quality)
        card_s += t1 - t0
        cpu_s += time.perf_counter() - t1
        ends += int(out_c[2].all())
        check(all(np.isfinite(v).all() for v in out_c[0].values()), f"step {t}: obs not finite")
        _np_same({**dict(zip(keys, out_c)), "labels": card.current_labels,
                  "pos": card._episode.pos, "pos_dev": card._episode.pos_dev.cpu().numpy()},
                 {**dict(zip(keys, out_u)), "labels": cpu.current_labels,
                  "pos": cpu._episode.pos, "pos_dev": cpu._episode.pos_dev.numpy()},
                 f"step {t}", None, {})
    # Where a card step's time goes: one canvas stamp (host numpy, on
    # copies of the canvases) and one observation (device sensing, copy).
    from apx_torch.render.render import stamp_rect

    counts, qmap = card._canvas.counts.copy(), card._canvas.quality.copy()
    t0 = time.perf_counter()
    stamp_rect(counts, qmap, *card._sensor_footprint(), rng.uniform(0, 1, PM_N))
    stamp_ms = 1e3 * (time.perf_counter() - t0)
    del counts, qmap
    t0 = time.perf_counter()
    card._get_obs()
    obs_ms = 1e3 * (time.perf_counter() - t0)
    # The unique sampler: the card's at N=4096 against the CPU's on envs
    # spread over the batch, with the same draws.
    m = PM_UNIQUE_CPU_ENVS
    envs = slice(0, PM_N, PM_N // m)
    cell, grid = card._candidate_grid()
    draws = copy.deepcopy(card._rng)
    t0 = time.perf_counter()
    pos_card = card.sample_unique_glimpse_positions()
    sample_ms = 1e3 * (time.perf_counter() - t0)
    scores_card = card._uniqueness_scores(grid)
    scores_cpu = cpu._uniqueness_scores(grid, envs)
    check(scores_cpu.shape[0] == m, f"{scores_cpu.shape[0]} envs scored on the CPU")
    drift = float(np.abs(scores_card[envs] - scores_cpu).max())
    top = -np.sort(-scores_cpu, axis=-1)[:, :cfg.unique_sampling_top_k + 1]
    undecided = np.zeros(m, bool) if drift == 0 else \
        (np.diff(-top, axis=-1) <= 2 * drift).any(axis=-1)
    ranking = np.argsort(-scores_cpu)
    pick = draws.integers(0, cfg.unique_sampling_top_k, size=PM_N)
    jitter = draws.uniform(-cell, cell, (PM_N, 2))
    pos_cpu = np.clip(grid[ranking[np.arange(m), pick[envs]]] + jitter[envs], -1, 1)
    check(np.array_equal(pos_card[envs][~undecided], pos_cpu[~undecided]),
          "unique positions: card and CPU differ where the scores decide them")
    check(np.isfinite(pos_card).all() and (np.abs(pos_card) <= 1).all(),
          "unique positions outside [-1, 1]")
    card.close()
    cpu.close()
    check(ends == PM_STEPS // (cfg.step_limit + 1), f"{ends} LOCKSTEP episode ends")
    return {"num_envs": PM_N, "steps": PM_STEPS, "episode_ends": ends,
            "compared": "obs, rewards, dones, infos, labels, positions bitwise",
            "card_ms_per_step": 1e3 * card_s / PM_STEPS,
            "cpu_ms_per_step": 1e3 * cpu_s / PM_STEPS, "card_reset_ms": reset_ms,
            "host_stamp_ms": stamp_ms, "card_observation_ms": obs_ms,
            "candidates": len(grid), "card_sample_unique_ms": sample_ms,
            "unique_compared_envs": m, "unique_compared_stride": envs.step,
            "score_drift": drift,
            "undecided_envs": int(undecided.sum())}


def phase_glimpse_study(dev) -> dict:
    """Phase 27: apx's glimpse study at its geometry, on the card."""
    from apx_torch.ops import glimpse_study

    clear_launches()
    t0 = time.perf_counter()
    res = glimpse_study.run_study(dev)
    res["seconds"] = time.perf_counter() - t0
    k3 = launched("K3")
    check(k3 == res["k3_launches"] and k3 > 0,
          f"glimpse study: K3 launched {k3} times, the study counted {res['k3_launches']}")
    for name, v in res["variants"].items():
        for key in ("us_per_batch", "moving_us_per_batch", "alone_us_per_batch"):
            check(v[key] is not None and v[key] > 0, f"{name}: {key} not timed")
    return res


# ---- apx's A/B surfaces ---------------------------------------------------------

BACKEND_STEPS = 50  # masked-merge steps of each raycast backend's main path
BACKEND_CPU_STEPS = 30  # card vs CPU steps per backend, N = 256
AB_STEPS = 128  # graph steps per A/B run (default, variant, variant, default)
LIDAR_CONFIGS = {
    **{b: {"raycast_backend": b} for b in ("bitslab2d", "bitslab", "windowed", "hybrid",
                                           "mxu_window", "pallas", "xla")},
    "beam_rects": {"raycast_backend": "bitslab2d", "beam_rects": "on"},
    "beam_tables": {"use_beam_tables": True},
}


def backend_launches(name: str, steps: int) -> dict:
    """Kernel launches of a LIDAR path of ``steps`` masked-merge steps from
    its reset, under one of LIDAR_CONFIGS. The reset (once, then once per
    step: the merge's reset runs for every env) is R wherever its scan runs
    on the whole map, else K1 typed on the window (``"windowed"``,
    ``"mxu_window"``); the step is S where all its casts do (``"xla"``,
    ``"pallas"``), else F1's 4 stages around K1's 3 fast casts: none under
    the bit windows (plain PyTorch), 2 under the beam tables (the scan is a
    lookup). F2 once per step under every backend."""
    dense_reset = name not in ("windowed", "mxu_window")
    out = {"F2": steps, "R": 1 + steps if dense_reset else 0,
           "K1.raycast_typed_launch": 0 if dense_reset else 1 + steps}
    if name in ("xla", "pallas"):
        return {**out, "S": steps, "F1": 0, "K1.raycast_fast_launch": 0}
    fast = {"bitslab2d": 0, "bitslab": 0, "beam_rects": 0, "beam_tables": 2}.get(name, 3)
    return {**out, "S": 0, "F1": 4 * steps, "K1.raycast_fast_launch": fast * steps}


def _lidar_build(config: dict):
    """``build(n, device)`` of LIDARLocRooms-v0 under ``config`` (with the
    bank's beam tables under ``use_beam_tables``)."""
    from apx_torch.bench import _registered

    return lambda n, dev: _registered("LIDARLocRooms-v0")(n, dev, **config)


def phase_backend_kernels(dev) -> dict:
    """K1 on the windows of the window-frame backends, at N = 4096 on rooms
    maps with the step's casts (``kernel_inputs``): ``"windowed"``'s
    (2r + 2)^2 windows around each cast's origin (18x18 for the beam and
    reset scans, 6x6 for the moves) and ``"mxu_window"``'s 16x16 one-hot
    windows around the pre-move position, bitwise the plain form in the
    window frame; device ms, plain ms and bound of each. Then the pieces of
    ``bitslab2d``'s step, plain PyTorch: its bit window and its three
    lattice casts, device ms each."""
    from apx_torch.data.floor_map import make_rooms_bank
    from apx_torch.ops import raycast_cuda
    from apx_torch.ops.raycast import (bitslab_window_2d, extract_window_mxu,
                                       raycast_grid, raycast_grid_bitslab2d, seg_length,
                                       windowed_window)

    gen = torch.Generator(device=dev).manual_seed(30)
    bank = make_rooms_bank(256, device=dev)
    out: dict = {}
    for name, cases in kernel_inputs(bank, gen, dev).items():
        kernel = getattr(raycast_cuda, name)
        typed = name == "raycast_typed"
        for occ, origin, targets in cases:
            r = targets.shape[1]
            forms = {"windowed": windowed_window(occ, origin, 8 if r == 8 else 2, 8),
                     "mxu": extract_window_mxu(occ, 8, origin)}
            for form, (win, base) in forms.items():
                o, t = origin - base, targets - base[:, None]
                seg = seg_length(t - o[:, None])
                got = kernel(win, o, t, seg)
                want = raycast_grid(win, o, t, seg, geos_typing=typed)[0]
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                      f"{name} on {form} windows, R={r}: not bitwise equal (max |diff| {err})")
                b_ms, b_by = bound(name, win, o, t)
                out.setdefault(name, {}).setdefault(form, {})[r] = {
                    "ms": device_ms(lambda: kernel(win, o, t, seg), 50),
                    "plain_ms": device_ms(
                        lambda: raycast_grid(win, o, t, seg, geos_typing=typed), 4),
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                    "shape": "x".join(map(str, win.shape[1:]))}
    # bitslab2d's step pieces: the window from the row halves, then the
    # move (rho 2: 6x6), the slide (rho 2) and the beams (rho 6: 14x14).
    occ, origin, _ = kernel_inputs(bank, gen, dev)["raycast_fast"][0]
    bank_pos = torch.randint(0, bank.num_maps, (N,), generator=gen, device=dev)
    halves = bank.fetch_halves(bank_pos)
    base = torch.floor(origin) - 7
    win = bitslab_window_2d(halves, base[:, 0], base[:, 1], 32)
    casts = {f"R={t.shape[1]}": (t, rho) for (_, _, t), rho in
             zip(kernel_inputs(bank, gen, dev)["raycast_fast"], (2, 2, 6))}
    pieces = {"window_ms": device_ms(
        lambda: bitslab_window_2d(halves, base[:, 0], base[:, 1], 32), 20)}
    for key, (targets, rho) in casts.items():
        lo, hi = 7 - rho - 1, 7 + rho + 1
        sub, bx, by = win[:, lo:hi, lo:hi], base[:, 0] + lo, base[:, 1] + lo
        pieces[f"lattice_{key}_ms"] = device_ms(
            lambda: raycast_grid_bitslab2d(sub, bx, by, origin, targets), 10)
    out["bitslab2d_pieces"] = pieces
    return out


def phase_backend_path(dev, name: str, config: dict) -> dict:
    """LIDARLocRooms-v0 at N = 4096 under one of LIDAR_CONFIGS: the reset and
    BACKEND_STEPS steps of uniform actions with zero predictions, every obs
    finite, lidar in [0, 1], rewards in [-2.9, 0.1], and the K1 launches of
    ``backend_launches``, counted from 0 over the path."""
    venv, params = _lidar_build(config)(N, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    zero_pred = torch.zeros((N, 2), device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    r_lo = torch.full((), float("inf"), device=dev)
    r_hi = torch.full((), -float("inf"), device=dev)
    torch.cuda.synchronize()
    clear_launches()
    t0 = time.perf_counter()
    obs, state, _ = venv.reset(params, gen)
    for _ in range(BACKEND_STEPS):
        act = torch.rand((N, 2), generator=gen, device=dev) * 2 - 1
        obs, state, reward, *_ = venv.step(state, {"action": act, "prediction": zero_pred},
                                           params, gen)
        for leaf in obs.values():
            ok &= torch.isfinite(leaf).all()
        ok &= ((obs["lidar"] >= 0) & (obs["lidar"] <= 1)).all()
        r_lo = torch.minimum(r_lo, reward.min())
        r_hi = torch.maximum(r_hi, reward.max())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(ok), f"{name}: non-finite obs or lidar outside [0, 1]")
    check(-2.9 <= float(r_lo) and float(r_hi) <= 0.1,
          f"{name}: rewards outside [-2.9, 0.1]: [{float(r_lo)}, {float(r_hi)}]")
    want = backend_launches(name, BACKEND_STEPS)
    got = launch_counts(want)
    check(got == want, f"{name} path launches {got}, expected {want}")
    return {"backend": name, "config": config, "steps": BACKEND_STEPS,
            "eager_ms_per_step": 1e3 * dt / BACKEND_STEPS, "launches": got}


def phase_raycast_backends(dev) -> dict:
    """Every LIDAR config: its main path (``phase_backend_path``), its
    card vs CPU trajectory at N = 256 (bitwise, BACKEND_CPU_STEPS steps),
    the graph ms per step against the default in one process
    (``bench.bench_ab``), and for bitslab2d the profiled busy time with its
    pieces' share (``phase_backend_kernels``)."""
    from apx_torch.bench import bench_ab, profile

    res: dict = {"paths": {}, "card_vs_cpu": {}, "ab": {}}
    for name, config in LIDAR_CONFIGS.items():
        res["paths"][name] = phase_backend_path(dev, name, config)
        cv = phase_card_vs_cpu(dev, "LIDARLocRooms-v0", 256, BACKEND_CPU_STEPS, {},
                               build=_lidar_build(config))
        res["card_vs_cpu"][name] = {"steps": cv["steps"], "bitwise": cv["bitwise"]}
        ab = bench_ab("lidar_rooms", config, N, AB_STEPS)
        res["ab"][name] = {k: ab[k] for k in ("default_graph_ms_per_step",
                                              "variant_graph_ms_per_step",
                                              "variant_over_default")}
    prof = profile("lidar_rooms", N, overrides=LIDAR_CONFIGS["bitslab2d"])
    res["bitslab2d_profile"] = {k: prof[k] for k in ("device_busy_ms_per_step",
                                                     "kernel_launches_per_step",
                                                     "device_idle_share", "float64_ms_per_step")}
    return res


SWEEP_N = 16384
SWEEP_CPU_EVERY = 1024  # the streamed sweep's envs compared with the CPU


def _sweep_reset(venv, params, draws) -> dict:
    """One explicit reset from ``draws``: its ms and the peak of
    ``max_memory_allocated`` above the start, and its K3 launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    clear_launches()
    t0 = time.perf_counter()
    out = venv.reset(params, draws=draws)
    torch.cuda.synchronize()
    return {"ms": 1e3 * (time.perf_counter() - t0),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_above_start_bytes": torch.cuda.max_memory_allocated() - start,
            "glimpse_launches": launched("K3")}, out


def phase_samplers(dev) -> dict:
    """TinyImageNetLoc-v0's explicit reset under the samplers: streamed at
    N = 16384 (ms, peak memory; its scores against the CPU's on every
    SWEEP_CPU_EVERY-th env, within SCORE_TOL, top-k equal where the gaps
    decide), chunked and cartesian (and streamed) at N = 4096, cartesian at
    N = 16384 where it fits in the card's memory. Each reset after a warmup
    reset of its own; chunked launches K3 once per 27 candidates. At N =
    4096 the chunked and streamed scores of one set of images are held to
    the cartesian scores within SCORE_TOL, their top-k equal where the gaps
    decide, and one chunk of K3 by index (4096 x 27 glimpses) to its plain
    form on the same inputs within GLIMPSE_TOL."""
    import apx_torch
    from apx_torch.core.numerics import matmul_tf32
    from apx_torch.envs.image_perception import CHUNK, ImagePerceptionEngine as engine
    from apx_torch.ops.glimpse import extract_glimpse_batch
    from apx_torch.ops.glimpse_cuda import glimpse

    res: dict = {}
    images_n, scores = None, {}  # the N = 4096 images and each sampler's scores of them
    for backend, n in (("streamed", SWEEP_N), ("streamed", N), ("chunked", N), ("auto", N),
                       ("auto", SWEEP_N)):
        venv, params = apx_torch.make_vec("TinyImageNetLoc-v0", num_envs=n, device=dev,
                                          unique_sampling_backend=backend)
        draws = venv.env.draw_reset(n, params, torch.Generator(device=dev).manual_seed(n))
        key = f"{'cartesian' if backend == 'auto' else backend}_n{n}"
        try:
            venv.reset(params, draws=draws)  # warmup
            res[key], (_, state, _) = _sweep_reset(venv, params, draws)
        except torch.cuda.OutOfMemoryError as e:
            res[key] = {"fits": False, "error": str(e).splitlines()[0][:200]}
            torch.cuda.empty_cache()
            continue
        want = 2 + (27 if backend == "chunked" else 0)
        check(res[key]["glimpse_launches"] == want,
              f"{key}: glimpse launched {res[key]['glimpse_launches']} times, not {want}")
        if (backend, n) == ("streamed", SWEEP_N):
            images = engine.image_raw(state.inner.perception, params)
            u_dev = engine.uniqueness(images, params)[::SWEEP_CPU_EVERY].cpu().numpy()
            cpu_params = apx_torch.make("TinyImageNetLoc-v0", device="cpu",
                                        unique_sampling_backend="streamed")[1]
            u_cpu = engine.uniqueness(images[::SWEEP_CPU_EVERY].cpu(), cpu_params).numpy()
            err = float(np.abs(u_cpu - u_dev).max())
            check(err <= SCORE_TOL, f"streamed scores card vs cpu: max |diff| {err}")
            res[key]["cpu_envs_compared"] = int(u_cpu.shape[0])
            res[key]["score_max_abs_err"] = err
        if n == N:
            if images_n is None:
                images_n = engine.image_raw(state.inner.perception, params).clone()
            scores[key] = engine.uniqueness(images_n, params).cpu().numpy()
        if (backend, n) == ("chunked", N):  # one chunk of K3 by index against its plain form
            cand = engine.candidate_grid(params)[0][:CHUNK].repeat(N, 1)
            index = torch.arange(N, device=dev).repeat_interleave(CHUNK)
            got = glimpse(images_n, cand, params.sensor_size, params.sensor_scale, index=index)
            with matmul_tf32(False):
                want = extract_glimpse_batch(images_n[index], cand, params.sensor_size,
                                             params.sensor_scale)
            err = (got - want).abs().max().item()
            check(err <= GLIMPSE_TOL, f"chunked K3 by index vs plain: max |diff| {err}")
            res[key]["k3_chunk_glimpses"] = int(index.shape[0])
            res[key]["k3_chunk_max_abs_err"] = err
            del got, want, cand, index
        del venv, params, draws, state
        torch.cuda.empty_cache()
    ref = scores[f"cartesian_n{N}"]
    for name in ("chunked", "streamed"):
        u = scores[f"{name}_n{N}"]
        err = float(np.abs(u - ref).max())
        check(err <= SCORE_TOL, f"{name} vs cartesian scores at N={N}: max |diff| {err}")
        top = np.argsort(-u, axis=-1, kind="stable")[:, :TOP_K]
        top_ref = np.argsort(-ref, axis=-1, kind="stable")[:, :TOP_K]
        decided = [i for i in range(N) if ranking_gap(ref[i], u[i]) is not None]
        check(len(decided) > 0, f"{name} vs cartesian: no env's ranking was decided")
        check(all(np.array_equal(top[i], top_ref[i]) for i in decided),
              f"{name} vs cartesian: top-k differs where the gaps decide")
        res[f"{name}_n{N}"]["vs_cartesian"] = {"score_max_abs_err": err,
                                               "envs_topk_compared": len(decided)}
    return res


STORAGE_STEPS = 20


def phase_image_storage(dev) -> dict:
    """tin_loc (the 100,000-image bank) at N = 4096 under each storage mode
    and the row window: STORAGE_STEPS masked-merge steps from the same draws
    as the "array" run, bitwise equal to it (the row window's glimpses
    bitwise the plain "off" form and within GLIMPSE_TOL of K3's), K3's
    launches counted on each path; then the graph ms per step of each
    against "array"/"off" in one process (``bench.bench_ab``). Then K3 and
    the row gather over the 1.23 GB bank, larger than L2: K3 reading bank
    rows through its index, K3 on the gathered rows, and the gather."""
    from apx_torch.bench import _loop, bench_ab
    from apx_torch.core.numerics import matmul_tf32
    from apx_torch.envs.image_perception import ImagePerceptionEngine as engine
    from apx_torch.ops.glimpse import extract_glimpse_batch
    from apx_torch.ops.glimpse_cuda import glimpse

    configs = {"packed": {"image_storage": "packed"}, "flat": {"image_storage": "flat"},
               "gather": {"image_storage": "gather"}, "rows": {"glimpse_window": "rows"}}
    res: dict = {"paths": {}, "ab": {}}
    base_lp = _loop("tin_loc", N, dev, bank_points=TIN_BANK)

    def run(lp, draws, steps_draws):
        """The path's reset and steps: (obs, reward, perception state) per
        step, and K3's launches at the reset and over the steps."""
        torch.cuda.synchronize()
        clear_launches()
        obs, state, _ = lp.venv.reset(lp.params, draws=draws)
        at_reset = launched("K3")
        outs = []
        for act, rd in steps_draws:
            obs, state, reward, *_ = lp.venv.step(state, act, lp.params, reset_draws=rd)
            outs.append((obs, reward, state.inner.perception))
        torch.cuda.synchronize()
        return outs, at_reset, launched("K3") - at_reset

    g = torch.Generator(device=dev).manual_seed(5)
    draws = base_lp.venv.env.draw_reset(N, base_lp.params, g)
    steps_draws = [({"action": torch.rand((N, 2), generator=g, device=dev) * 2 - 1,
                     "prediction": torch.zeros((N, 2), device=dev)},
                    base_lp.venv.env.draw_reset(N, base_lp.params, g))
                   for _ in range(STORAGE_STEPS)]
    want, want_reset, want_steps = run(base_lp, draws, steps_draws)
    check((want_reset, want_steps) == (2, 3 * STORAGE_STEPS),
          f"array path: glimpse launched {want_reset} + {want_steps}")
    res["paths"]["array"] = {"glimpse_launches": [want_reset, want_steps]}
    for name, config in configs.items():
        lp = _loop("tin_loc", N, dev, overrides=config, bank_points=TIN_BANK)
        got, at_reset, over_steps = run(lp, draws, steps_draws)
        for t, ((o, r, p), (oa, ra, _)) in enumerate(zip(got, want)):
            for k in o:
                if name == "rows" and k in ("glimpse", "target_glimpse"):
                    err = (o[k] - oa[k]).abs().max().item()
                    check(err <= GLIMPSE_TOL, f"rows {k} vs K3: max |diff| {err}")
                    if k == "glimpse":
                        off = extract_glimpse_batch(engine.image_raw(p, lp.params), p.pos,
                                                    (10, 10))
                        check(torch.equal(o[k], off), "rows glimpse not bitwise the 'off' form")
                else:
                    check(torch.equal(o[k], oa[k]), f"{name} step {t} obs {k} differs from array")
            check(torch.equal(r, ra), f"{name} step {t} reward differs from array")
        expect = (0, 0) if name == "rows" else (want_reset, want_steps)
        check((at_reset, over_steps) == expect,
              f"{name}: glimpse launched {at_reset} + {over_steps}, expected {expect}")
        res["paths"][name] = {"steps": STORAGE_STEPS, "glimpse_launches": [at_reset, over_steps]}
        del got
        ab = bench_ab("tin_loc", config, N, 170, bank_points=TIN_BANK)
        res["ab"][name] = {k: ab[k] for k in ("default_graph_ms_per_step",
                                              "variant_graph_ms_per_step",
                                              "variant_over_default")}
    # K3 over a bank larger than L2 (the tin_loc bank, 1.23 GB of uint8).
    bank = base_lp.params.dataset
    g = torch.Generator(device=dev).manual_seed(7)
    idx = torch.randint(0, bank.length, (N,), generator=g, device=dev)
    pos = torch.rand((N, 2), generator=g, device=dev) * 2 - 1
    rows = bank.images[idx]
    got = glimpse(bank.images, pos, (10, 10), index=idx)
    check(torch.equal(got, glimpse(rows, pos, (10, 10))), "K3 by index != K3 on gathered rows")
    with matmul_tf32(False):
        err = (got - extract_glimpse_batch(rows, pos, (10, 10))).abs().max().item()
    check(err <= GLIMPSE_TOL, f"K3 by index over the bank vs plain: max |diff| {err}")
    b_ms, b_by = glimpse_bound(rows, pos, (10, 10), 1.0)
    res["bank_larger_than_l2"] = {
        "bank_bytes": bank.images.numel(), "shape": f"N={N} of {bank.length} 64x64x3 u8, 10x10",
        "k3_index_max_abs_err": err,
        "k3_index_ms": device_ms(lambda: glimpse(bank.images, pos, (10, 10), index=idx), 50),
        "k3_rows_ms": device_ms(lambda: glimpse(rows, pos, (10, 10)), 50),
        "row_gather_ms": device_ms(lambda: bank.images[idx], 50),
        "bound_ms": b_ms, "bound_by": b_by}
    return res


def phase_sharded_bank(dev) -> dict:
    """The bank sharded over two gloo ranks on cuda:0 (``selftest
    --shard-bank``, both pairs of ranks at once): LIDARLocRooms-v0 (N =
    4096, 30 steps) and the episodic CircleSquare-v0 (its image bank; N =
    4096, 34 steps): each rank's block
    of the final state bitwise the replicated solo run's, each rank holding
    only its block of every bank leaf (bitwise the whole bank's rows; the
    card memory the sharding allocated, ``memory_allocated`` before and
    after, is the block's), and the bytes per step its fetches moved. Then ``bench --distributed
    --shard-bank`` over torchrun: the eager ms per step of each rank with
    the bank replicated and sharded, interleaved in one pair of processes."""
    res = {}
    runs = (("LIDARLocRooms-v0", 30, None), ("CircleSquare-v0", 34, 16))
    stores = [tempfile.mkdtemp(prefix="apx_store_") for _ in runs]
    try:  # both pairs of ranks at once
        outs = _spawn([[sys.executable, "-m", "apx_torch.distrib.selftest", "--rank", str(r),
                        "--world", "2", "--init", f"file://{store}/store", "--backend", "gloo",
                        "--device", "cuda:0", "--env", env_id, "--num-envs", str(N), "--steps",
                        str(steps), "--shard-bank",
                        *(["--episodic-period", str(period)] if period is not None else [])]
                       for store, (env_id, steps, period) in zip(stores, runs) for r in range(2)],
                      {})
    finally:
        for store in stores:
            shutil.rmtree(store, ignore_errors=True)
    for i, (env_id, steps, _) in enumerate(runs):
        ranks = [_tagged(out, "SELFTEST ") for out in outs[2 * i:2 * i + 2]]
        solo = ranks[0]["solo"]
        kernels = ("N1", "S", "R") if env_id.startswith("LIDAR") else ("N1", "K3")
        for r, out in enumerate(ranks):
            check(out["digest"] == solo["digests"][r],
                  f"{env_id} sharded bank: rank {r}'s block is not bitwise the solo run's")
            check(all(launched(k, out["launches"]) for k in kernels),
                  f"{env_id} sharded bank: rank {r} launched {out['launches']}, not each of "
                  f"{kernels}")
            check(out["bank"]["digest"] == solo["bank_digests"][r],
                  f"{env_id} sharded bank: rank {r} does not hold its block")
            m = out["bank"]["num_rows"]
            check(set(out["bank"]["leaf_rows"].values()) == {m // 2},
                  f"{env_id} sharded bank: rank {r} holds {out['bank']['leaf_rows']} rows")
            # What the shard allocated on the card: its block, not the bank
            # (each allocation rounds up to 512 bytes).
            b = out["bank"]
            check(b["storage_bytes"] == b["leaf_bytes"] and 2 * b["leaf_bytes"]
                  == b["whole_bank_bytes"], f"{env_id} sharded bank: rank {r} storage {b}")
            added = b["device_bytes_added"]
            check(added is not None and b["leaf_bytes"] <= added
                  <= b["leaf_bytes"] + 512 * len(b["leaf_rows"]) < b["whole_bank_bytes"],
                  f"{env_id} sharded bank: rank {r} allocated {added} bytes on the card for "
                  f"a block of {b['leaf_bytes']} (whole bank {b['whole_bank_bytes']})")
        res[env_id] = {"steps": steps, "num_envs": N, "bank_rows": ranks[0]["bank"]["num_rows"],
                       "ranks": [{"ms_per_step": 1e3 * o["seconds"] / steps,
                                  "bytes_per_step": o["bank"]["bytes_per_step"],
                                  "device_bytes_added": o["bank"]["device_bytes_added"],
                                  "block_bytes": o["bank"]["leaf_bytes"],
                                  "whole_bank_bytes": o["bank"]["whole_bank_bytes"],
                                  "launches": o["launches"]} for o in ranks],
                       "solo_ms_per_step": 1e3 * solo["seconds"] / steps}
    out = _spawn([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node=2", "-m", "apx_torch.bench", "--distributed", "--shard-bank",
                   "--env", "lidar_rooms", "--backend", "gloo", "--device", "cuda:0",
                   "--num-steps", "64"]], {})[0]
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(len(lines) == 1, f"sharded-bank bench: {len(lines)} result lines")
    res["bench"] = json.loads(lines[0])
    return res


def phase_parse_trace(dev) -> list[str]:
    """Phase 28: parse_trace on the eager and graph traces of the LIDAR
    loop. Returns the lines to print."""
    import collections

    from apx_torch.bench import profile, profile_graph
    from apx_torch.tools import parse_trace as pt

    tmp = tempfile.mkdtemp(prefix="apx_trace_")
    try:
        prof = profile("lidar_rooms", N, trace_path=os.path.join(tmp, "eager.json"))
        trace = pt.load_trace(prof["trace"])
        steps = prof["steps"]
        dev_events = pt.device_events(trace)
        launches = len(dev_events) / steps
        summed = pt.device_summed_us(trace) / 1e3 / steps
        check(launches == prof["kernel_launches_per_step"],
              f"parse_trace: {launches} device activities per step, profile() counts "
              f"{prof['kernel_launches_per_step']}")
        busy = prof["device_busy_ms_per_step"]
        check(abs(summed - busy) <= 0.01 * busy,
              f"parse_trace: summed {summed} ms per step against profile()'s {busy}")
        union = pt.device_busy_us(trace) / 1e3 / steps
        gaps = pt.idle_gaps(trace, 5)
        cats = collections.Counter(e.get("cat") for e in dev_events)
        names = pt._process_names(trace["traceEvents"])
        procs = sorted({names.get(e.get("pid"), "?") for e in dev_events})
        eager = {"workload": prof["workload"], "num_envs": N, "steps": steps,
                 "activities_per_step": launches,
                 "profile_kernel_launches_per_step": prof["kernel_launches_per_step"],
                 "summed_ms_per_step": summed, "profile_device_busy_ms_per_step": busy,
                 "union_busy_ms_per_step": union,
                 "wall_ms_per_step": prof["wall_ms_per_step"],
                 "idle_share": 1.0 - union / prof["wall_ms_per_step"],
                 "device_categories": dict(cats), "device_processes": procs,
                 "idle_gaps": gaps}
        g = profile_graph("lidar_rooms", N, trace_path=os.path.join(tmp, "graph.json"))
        gtrace = pt.load_trace(g["trace"])
        gevents = pt.device_events(gtrace)
        host_launches = sum(1 for e in gtrace.get("traceEvents", [])
                            if e.get("ph") == "X" and "GraphLaunch" in str(e.get("name")))
        graph = {"workload": g["workload"], "steps": g["steps"], "chunk": g["chunk"],
                 "wall_ms_per_step": g["wall_ms_per_step"],
                 "unprofiled_wall_ms_per_step": g["unprofiled_wall_ms_per_step"],
                 "host_graph_launches": host_launches}
        if gevents:
            gu = pt.device_busy_us(gtrace) / 1e3 / g["steps"]
            graph.update({"activities_per_step": len(gevents) / g["steps"],
                          "union_busy_ms_per_step": gu,
                          "summed_ms_per_step": pt.device_summed_us(gtrace) / 1e3 / g["steps"],
                          "idle_share": 1.0 - gu / g["unprofiled_wall_ms_per_step"],
                          "idle_share_profiled_wall": 1.0 - gu / g["wall_ms_per_step"],
                          "device_categories": dict(collections.Counter(
                              e.get("cat") for e in gevents)),
                          "idle_gaps": pt.idle_gaps(gtrace, 5)})
        else:
            graph["note"] = "CUPTI recorded no device activity from inside the graph"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [f"parse_trace eager: {json.dumps(eager)}", f"parse_trace graph: {json.dumps(graph)}"]


# ---- the training path (phases 35-38) ----------------------------------------

TRAIN_N, TRAIN_T, TRAIN_ITERS = 1024, 32, 3  # train_ppo_lidar's published defaults
TRAIN_CPU_N, TRAIN_CPU_T = 64, 8
# The net after one iteration, card against CPU (TF32 off), and a grid
# rank's trunk rows against the one-process run's: the same iteration whose
# products and convolutions sum in other orders (cuDNN, cuBLAS, the CPU's).
# apx holds its own mesh run to this bound (tests/test_distrib.py); on an
# H100 the card-vs-CPU weights differed by up to 4.4e-6 (map_proj) and the
# grid's trunk rows by 2.6e-6.
TRAIN_NET_TOL = 2e-5
GRID_N, GRID_T = 256, 16  # train_ppo_mesh's defaults
PRED_PATH = ("pred", "trunk", "map_proj", "prop", "conv1", "conv2")


def phase_train_ppo(dev) -> dict:
    """Phase 35: ``train_ppo_lidar`` at its published width on the card:
    LIDARLocRooms-v0 at N = 1024, rollout 32, 2 epochs x 4 minibatches,
    TRAIN_ITERS iterations. Losses and rewards finite, the prediction
    gradient nonzero on the prediction path and zero on the policy and
    value heads, every weight finite; the launches in each iteration, the
    counts set to 0 just before it: S, R (the masked merge's reset) and F2
    once per rollout step, and R once at the reset. The rollout and update seconds of each
    iteration and the env-steps/s including the update after the first."""
    import apx_torch
    from apx_torch.examples.train_ppo_lidar import ClipAdam, init_net, make_train_iter

    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", TRAIN_N, device=dev)
    g = torch.Generator(dev).manual_seed(0)
    clear_launches()
    obs, state, _ = venv.reset(params, g)
    torch.cuda.synchronize()
    reset_launches = kernel_launches(nonzero=True)
    check(reset_launches == {"R": 1}, f"train reset launched {reset_launches}, expected one R")
    net = init_net(g, params.map_bank.map_hw, dev)
    opt = ClipAdam(0.5, 3e-4)
    opt_state = opt.init(net)
    train_iter = make_train_iter(venv, opt, TRAIN_N, TRAIN_T)
    want = {"S": TRAIN_T, "R": TRAIN_T, "F2": TRAIN_T}
    iters = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_ITERS):
        stats = {}
        clear_launches()
        t0 = time.perf_counter()
        state, obs, mean_r = train_iter(net, opt_state, state, obs, g, params, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches(nonzero=True)
        check(launches == want, f"train iteration {i} launched {launches}, expected {want}")
        numerics = numerics_launches(f"train iteration {i}", TRAIN_T, roots=False)
        mean_r = float(mean_r)
        losses = [stats["pred_loss"], *stats["ppo_losses"]]
        check(np.isfinite(mean_r) and np.isfinite(losses).all(),
              f"train iteration {i}: reward {mean_r}, losses {losses}")
        sq = stats["pred_grad_sq"]
        check(all(sq[k] > 0 for k in PRED_PATH) and sq["policy"] == sq["value"] == 0.0,
              f"train iteration {i}: prediction gradient's squared norms {sq}")
        check(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
              f"train iteration {i}: a weight is not finite")
        iters.append({"mean_reward": mean_r, "pred_loss": stats["pred_loss"],
                      "ppo_loss_last": stats["ppo_losses"][-1], "wall_s": wall,
                      "rollout_ms": 1e3 * stats["rollout_s"], "update_ms": 1e3 * stats["update_s"],
                      "launches": launches, "numerics_launches": numerics,
                      "pred_grad_sq": sq})
    steady = iters[1:]
    return {"env": "LIDARLocRooms-v0", "num_envs": TRAIN_N, "rollout_len": TRAIN_T,
            "epochs": 2, "num_minibatches": 4, "iterations": iters,
            "reset_launches": reset_launches, "launches_per_iteration": want,
            "env_steps_per_s_incl_update": TRAIN_N * TRAIN_T * len(steady)
            / sum(x["wall_s"] for x in steady),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32}}


def _to_device(tree, dev):
    from apx_torch.core.env import tree_map

    return tree_map(lambda x: x.to(dev), tree)


def phase_train_card_vs_cpu(dev) -> dict:
    """Phase 36: one PPO iteration at N = 64, rollout 8 on the card and on
    the CPU from the same weights and the same draws (made on the CPU and
    injected), TF32 off: mean rewards within rtol 1e-5, every weight after
    the iteration within TRAIN_NET_TOL (the largest |difference| printed)."""
    import apx_torch
    from apx_torch.core.numerics import matmul_tf32
    from apx_torch.examples.train_ppo_lidar import ClipAdam, PPONet, init_net, make_train_iter

    n, t = TRAIN_CPU_N, TRAIN_CPU_T
    cpu = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    g = torch.Generator().manual_seed(1)
    env = cpu[0].env
    reset = env.draw_reset(n, cpu[1], g)
    draws = {"noise": torch.randn((t, n, 2), generator=g),
             "reset": [env.draw_reset(n, cpu[1], g) for _ in range(t)],
             "perm": torch.stack([torch.randperm(t * n, generator=g) for _ in range(2)])
             .reshape(8, t * n // 4)}
    start = init_net(g, (32, 32), "cpu").state_dict()
    out = {}
    for where, (venv, params) in (("cpu", cpu),
                                  ("card", apx_torch.make_vec("LIDARLocRooms-v0", n, device=dev))):
        d = params.device
        net = PPONet((32, 32), d)
        net.load_state_dict(start)
        obs, state, _ = venv.reset(params, draws=_to_device(reset, d))
        opt = ClipAdam(0.5, 3e-4)
        train_iter = make_train_iter(venv, opt, n, t)
        with matmul_tf32(False):
            _, _, r = train_iter(net, opt.init(net), state, obs, None, params,
                                 draws=_to_device(draws, d))
        out[where] = (float(r), {k: v.cpu() for k, v in net.state_dict().items()})
    (r_cpu, w_cpu), (r_card, w_card) = out["cpu"], out["card"]
    rel = abs(r_card - r_cpu) / abs(r_cpu)
    check(rel <= 1e-5, f"train card vs cpu: mean reward {r_card} vs {r_cpu} (rel {rel})")
    diffs = {k: float((w_card[k] - w_cpu[k]).abs().max()) for k in w_cpu}
    worst = max(diffs.values())
    check(worst <= TRAIN_NET_TOL, f"train card vs cpu: weights differ by {diffs}")
    moved = min(float((w_cpu[k] - start[k]).abs().max()) for k in start)
    return {"num_envs": n, "rollout_len": t, "mean_reward_cpu": r_cpu, "mean_reward_card": r_card,
            "reward_rel_diff": rel, "weights_max_abs_diff": worst, "tolerance": TRAIN_NET_TOL,
            "weights_max_abs_diff_by_leaf": diffs, "smallest_leaf_move": moved}


def phase_train_grid(dev) -> dict:
    """Phase 37: ``grid_selftest`` on four gloo ranks sharing cuda:0 (a 2 x 2
    (data, model) grid), N = 256, rollout 16, TF32 off: the mesh PPO equal to
    its one-process run (mean reward rtol 1e-5, each rank's trunk rows within
    TRAIN_NET_TOL), each rank holding its 128 trunk rows; two V-trace
    iterations (sync every 2: behavior == learner, bitwise) and two R2D2
    iterations (ptr == filled == 2, target == online), each equal to its
    one-process run (rewards rtol 1e-5, the trunk rows' first-iteration
    gradient within 1e-5 of its largest entry; the weights after Adam's
    steps are reported, ``train_ppo_mesh.trunk_grad_diff``); then the dry run
    (``graft_entry.dryrun_multichip``) on two gloo ranks on cuda:0: the
    sharded rollouts and the training step's loss equal to one process."""
    from apx_torch.examples.train_ppo_mesh import spawn_grid
    from apx_torch.graft_entry import dryrun_multichip

    del dev
    t0 = time.perf_counter()
    outs = spawn_grid("apx_torch.examples.grid_selftest", 4, "cuda:0", "gloo",
                      ["--num-envs", str(GRID_N), "--rollout-len", str(GRID_T),
                       "--num-minibatches", "4"], timeout=PHASE_TIMEOUT_S)
    grid_s = time.perf_counter() - t0
    ranks = [_tagged(out, "GRIDTEST ") for out in outs]
    for r, out in enumerate(ranks):
        what = f"grid rank {r}"
        check(out["grid"] == [2, 2] and out["device"] == "cuda:0", f"{what}: {out['grid']}")
        ppo, vt, rd = out["ppo"], out["vtrace"], out["r2d2"]
        rel = abs(ppo["mean_reward"] - ppo["solo_mean_reward"]) / abs(ppo["solo_mean_reward"])
        check(rel <= 1e-5, f"{what}: mesh PPO reward {ppo}")
        check(ppo["trunk_max_abs_diff"] <= TRAIN_NET_TOL, f"{what}: mesh PPO trunk {ppo}")
        check(ppo["trunk_shape"] == [256, 128], f"{what}: trunk shard {ppo['trunk_shape']}")
        check(vt["behavior_equals_learner"] and np.isfinite(vt["rewards"]).all(),
              f"{what}: V-trace {vt}")
        check(rd["ptr"] == rd["filled"] == 2 and rd["target_equals_online"]
              and np.isfinite(rd["rewards"]).all(), f"{what}: R2D2 {rd}")
        for name, res in (("V-trace", vt), ("R2D2", rd)):
            rel = np.abs(np.subtract(res["rewards"], res["solo_rewards"])) / np.abs(
                res["solo_rewards"])
            check(rel.max() <= 1e-5 and res["trunk_grad_rel_diff"] <= 1e-5,
                  f"{what}: {name} against its one-process run {res}")
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, "cuda:0", "gloo")  # raises if a rank's check fails
    dry_s = time.perf_counter() - t0
    for r in dry:
        ts = r["train_step"]
        rel = abs(ts["loss"] - ts["solo_loss"]) / abs(ts["solo_loss"])
        check(rel <= 1e-5 and np.isfinite(ts["loss"]) and ts["step_rel_diff"] <= 1e-5,
              f"dry run rank {r['rank']}: {ts}")
    return {"grid": {"world": 4, "backend": "gloo", "device": "cuda:0", "num_envs": GRID_N,
                     "rollout_len": GRID_T, "seconds": grid_s,
                     "ranks": [{"place": o["place"], **{k: o[k] for k in ("ppo", "vtrace", "r2d2")}}
                               for o in ranks]},
            "dryrun": {"world": 2, "seconds": dry_s, "ranks": dry}}


RESUME_N, RESUME_T = 256, 16


def train_resume_worker() -> dict:
    """Phase 38's subprocess (``chip_smoke.py --train-resume``, with
    CUBLAS_WORKSPACE_CONFIG set before CUDA starts): deterministic
    algorithms on, ``train_ppo_lidar.resume_check`` on the card (the check
    ``tests/test_torch_train_ppo.py`` runs on the CPU): two PPO iterations,
    the trainer saved, two more; a fresh trainer restored from the file and
    run two iterations: net, Adam state, obs, env state and generator
    bitwise the uninterrupted run's. Warnings about ops without a
    deterministic form are returned."""
    import warnings

    import apx_torch
    from apx_torch.examples.train_ppo_lidar import resume_check

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda")
    n, t = RESUME_N, RESUME_T
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device=dev)
    with warnings.catch_warnings(record=True) as caught, tempfile.TemporaryDirectory() as tmp:
        warnings.simplefilter("always")
        res = resume_check(venv, p, n, t, os.path.join(tmp, "trainer.pt"))
    return {"num_envs": n, "rollout_len": t, "iterations": "2 + 2", **res,
            "nondeterministic_warnings": sorted({str(w.message)[:200] for w in caught
                                                 if "determinis" in str(w.message)})}


def phase_train_resume() -> dict:
    """Phase 38: ``train_resume_worker`` in a subprocess (deterministic
    algorithms and the cuBLAS workspace setting stay out of this process's
    timings): the resumed trainer bitwise the uninterrupted one."""
    t0 = time.perf_counter()
    out = _spawn([[sys.executable, str(ROOT / "chip_smoke.py"), "--train-resume"]],
                 {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    res = _tagged(out[0], "RESUME ")
    check(res["bitwise"], f"trainer resume on the card is not bitwise: {res}")
    return res | {"seconds": time.perf_counter() - t0}


def phase_entry(dev) -> dict:
    """K3 on ``graft_entry.entry()``: the flagship CircleSquare (16x16, N =
    64) reset and one LOCKSTEP step at zero actions and logits, its counts
    set to 0 just before: ``glimpse`` 1 at the reset and 2 in the
    masked-merge step; glimpse in [0, 1], rewards -1 within 1e-6. Then K3
    held against its plain form (``extract_glimpse_batch``) at this path's
    inputs, within GLIMPSE_TOL: the step's observed glimpses against the
    plain glimpses of the stepped state's images and positions, and K3 at
    the reset state's images and positions against the plain form there."""
    from apx_torch.envs.image_perception import ImagePerceptionEngine
    from apx_torch.graft_entry import entry
    from apx_torch.ops.glimpse import extract_glimpse_batch

    clear_launches()
    fn, args = entry(dev)
    obs, state1, reward, term, trunc = fn(*args)
    torch.cuda.synchronize()
    launches = kernel_launches(nonzero=True)
    check(launches == {"K3": 3}, f"entry() launched {launches}, expected 3 K3")
    gl = obs["glimpse"]
    check(bool(torch.isfinite(gl).all()) and float(gl.min()) >= 0 and float(gl.max()) <= 1,
          "entry(): glimpse outside [0, 1]")
    err = float((reward + 1.0).abs().max())
    check(err <= 1e-6 and not bool((term | trunc).any()), f"entry(): reward -1 off by {err}")

    params = args[3]
    errs = {}
    for when, st in (("step", state1.inner), ("reset", args[1].inner)):
        images, index = ImagePerceptionEngine.glimpse_source(st, params)
        if index is not None:
            images = images[index]
        want = extract_glimpse_batch(images, st.pos, params.sensor_size, params.sensor_scale)
        got = gl if when == "step" else ImagePerceptionEngine.get_glimpse(st, st.pos, params)
        check(got.shape == want.shape, f"entry() {when}: glimpse {tuple(got.shape)} against "
                                       f"the plain form's {tuple(want.shape)}")
        errs[when] = float((got - want).abs().max())
        check(errs[when] <= GLIMPSE_TOL,
              f"entry() {when}: K3 against its plain form, max |diff| {errs[when]}")
    return {"launches": launches["K3"], "glimpse_shape": list(gl.shape),
            "image_shape": list(images.shape[1:]), "image_dtype": str(images.dtype),
            "max_abs_err": max(errs.values()), "max_abs_err_by_call": errs,
            "tolerance": GLIMPSE_TOL, "reward_max_abs_err_vs_minus_one": err}


# ---- apx's bench (PR 13) --------------------------------------------------------

# The bench's workload paths that bring K1 and K3 to shapes no phase above
# gives them: the maze (21x21) and static-rooms LIDAR paths at N = 4096,
# the rooms path at the scaling rows' N = 16384, CIFAR10's 32x32x3 glimpse
# at N = 4096 and MNIST's and TinyImageNet's at N = 16384.
SCALING_N = 16384
WORKLOAD_PATHS = (("lidar_maze", N), ("lidar_rooms_static", N), ("lidar_rooms", SCALING_N),
                  ("cifar10", N), ("mnist", SCALING_N), ("tin_loc", SCALING_N))
# apx's roofline stats, which every device record of the --deep capture carries.
DEEP_STATS = ("obs_bytes_per_step", "device_busy_us_per_step", "obs_hbm_roofline_us_per_step",
              "pct_of_obs_hbm_roofline")


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


@contextlib.contextmanager
def recorded_calls(module, names: tuple[str, ...], calls: dict, counts: dict,
                   labels: dict | None = None):
    """Replace the kernel wrappers ``names`` of ``module`` (an env module's
    imports, or a wrapper module whose functions the env calls through it)
    by pass-throughs that count their calls in ``counts`` (under
    ``labels[name]``, its launch count's name, where given) and keep a copy
    of the inputs of the first call per wrapper and ray count (K1) or per
    wrapper (K3, S, R) in ``calls``."""
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        name = (labels or {}).get(name, name)

        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            key = (name, args[2].shape[1] if name.startswith("raycast") else None)
            if key not in calls:
                calls[key] = ([_clone(a) for a in args], {k: _clone(v) for k, v in kwargs.items()})
            return fn(*args, **kwargs)

        return call

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def expected_workload_launches(name: str, steps: int, cycles: int) -> dict:
    """Kernel launches of a bench workload's reset and ``steps`` steps of
    its loop: a LIDAR step launches S, R (the merge's reset) and F2, the
    reset R; an episodic classification step (DISABLED or
    boundary) and the reset one glimpse; TinyImageNetLoc adds the target
    glimpse at the reset and at each cycle's boundary."""
    if name.startswith("lidar"):  # S, R (the merge's reset) and F2 per step
        return {"S": steps, "R": 1 + steps, "F2": steps}
    if name == "tin_loc":
        return {"K3": 2 + steps + cycles}
    return {"K3": 1 + steps}


def _hold_k1(name: str, args) -> dict:
    from apx_torch.ops import raycast_cuda
    from apx_torch.ops.raycast import raycast_grid, seg_length

    occ, origin, targets, seg = args
    own_len = seg is None
    if own_len:  # the lengths the kernel computes itself, for the plain form and the hold
        seg = seg_length(targets - origin[:, None, :])
    kernel = getattr(raycast_cuda, name)
    typed = name == "raycast_typed"
    got = kernel(occ, origin, targets, seg)
    want = raycast_grid(occ, origin, targets, seg, geos_typing=typed)[0]
    path_call = kernel(occ, origin, targets, None if own_len else seg)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"{name} R={targets.shape[1]} on a workload's inputs not bitwise its plain form "
          f"(max |diff| {err})")
    check(torch.equal(path_call.view(torch.int32), got.view(torch.int32)),
          f"{name} R={targets.shape[1]} on a workload's inputs with seg=None: not bitwise "
          f"the call with seg_length's lengths")
    b_ms, b_by = bound(name, occ, origin, targets)
    return {"ms": device_ms(lambda: kernel(occ, origin, targets, seg), 50),
            "plain_ms": device_ms(
                lambda: raycast_grid(occ, origin, targets, seg, geos_typing=typed), 4),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "library_ms": None,
            "own_len": own_len,
            # the call as the path makes it: with no seg the kernel computes |d|
            "wrapper_ms": device_ms(
                lambda: kernel(occ, origin, targets, None if own_len else seg), 50)}


def _hold_k3(args, kwargs) -> dict:
    from apx_torch.core.numerics import matmul_tf32
    from apx_torch.ops.glimpse import extract_glimpse_batch
    from apx_torch.ops.glimpse_cuda import glimpse

    images, pos, sensor, scale = args
    index = kwargs.get("index")
    rows = images if index is None else images[index]
    got = glimpse(images, pos, sensor, scale, index=index)
    with matmul_tf32(False):
        want = extract_glimpse_batch(rows, pos, sensor, scale)
        plain_ms = device_ms(lambda: extract_glimpse_batch(rows, pos, sensor, scale), 4)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err <= GLIMPSE_TOL, f"glimpse on a workload's inputs: max |diff| {err} > {GLIMPSE_TOL}")
    n, h, w, c = rows.shape
    b_ms, b_by = glimpse_bound(rows, pos, sensor, scale)
    return {"shape": f"N={n} {h}x{w}x{c} {str(images.dtype).split('.')[-1]}, "
                     f"{sensor[0]}x{sensor[1]} sensor" + ("" if index is None else ", by index"),
            "ms": device_ms(lambda: glimpse(images, pos, sensor, scale, index=index), 50),
            "plain_ms": plain_ms,
            "library_ms": device_ms(glimpse_library(rows, pos, sensor, scale), 50),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


def phase_workload_kernels(dev) -> dict:
    """The workload paths of WORKLOAD_PATHS, each driven through the bench's
    own loop (``apx_torch.bench._loop``, ``_steps`` over ``_draws``) from
    its explicit reset for one graph chunk (16 steps, or one 17-step
    LOCKSTEP cycle), eagerly. The launch counts are set to 0 just before
    each path and read just after: they must equal the wrappers' calls
    (each call launched) and ``expected_workload_launches``. The inputs of
    the first call of each kernel (and ray count) are kept and the kernel
    is held against its plain form on them (K1, S and R bitwise, K3 within
    GLIMPSE_TOL), with its device, plain and bound ms (and ``grid_sample``'s
    for K3; for K1 also the wrapper's call as the path makes it, which,
    where the env passes no segment lengths, computes them first)."""
    import apx_torch.envs.image_perception as image_mod
    import apx_torch.envs.lidar_localization as lidar_mod
    from apx_torch.bench import _draws, _loop, _steps
    from apx_torch.ops import lidar_fused_cuda

    out = {}
    for name, n in WORKLOAD_PATHS:
        lp = _loop(name, n, dev)
        g = torch.Generator(dev).manual_seed(11)
        calls, counts = {}, {}
        with recorded_calls(lidar_mod, ("raycast_fast", "raycast_typed"), calls, counts), \
                recorded_calls(lidar_fused_cuda, ("step", "reset"), calls, counts,
                               {"step": "fused_step", "reset": "fused_reset"}), \
                recorded_calls(image_mod, ("glimpse",), calls, counts):
            torch.cuda.synchronize()
            clear_launches()
            obs, state, _ = lp.venv.reset(lp.params, g)
            _steps(lp, obs, state, _draws(lp, lp.chunk, g),
                   torch.zeros((), device=dev))
            torch.cuda.synchronize()
            got = kernel_launches(nonzero=True)
        want = expected_workload_launches(name, lp.chunk, 1)
        check(got == want and {k: got.get(ROW_KEYS[k], 0) for k in counts} == counts,
              f"{name}: launches {got}, wrapper calls {counts}, expected {want}")
        res = {"num_envs": n, "steps": lp.chunk, "launches": got,
               "launches_per_step": {k: v / lp.chunk for k, v in got.items()},
               "kernels": {}}
        for (kernel, r), (args, kwargs) in calls.items():
            if kernel == "glimpse":
                res["kernels"]["glimpse"] = _hold_k3(args, kwargs)
            elif kernel.startswith("fused"):  # R's mask and bank operands come by keyword
                held = hold_fused(kernel, (*args, *kwargs.values()))
                held.pop("held")
                res["kernels"][kernel] = {"shape": f"N={n} H={args[0].shape[1]}", **held}
            else:
                occ = args[0]
                res["kernels"].setdefault(kernel, {"shape": f"N={n} {occ.shape[1]}x{occ.shape[2]}",
                                                   "by_r": {}})["by_r"][r] = _hold_k1(kernel, args)
        out[name] = res
        del lp, calls, obs, state
        torch.cuda.empty_cache()
    return out


def phase_deep_capture() -> dict:
    """``python -m apx_torch.bench --deep --emit FILE`` in a subprocess (the
    bench's one-process capture, every workload at N = 4096 and the scaling
    and compat rows, with the calibration number): no record carries an
    error, every value is positive, every device record carries apx's
    roofline stats (finite, positive), and the fingerprint says gpu."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "deep.json")
        _spawn([[sys.executable, "-m", "apx_torch.bench", "--deep", "--emit", path]], {})
        with open(path) as f:
            doc = json.load(f)
    check(doc["fingerprint"]["platform"] == "gpu", f"fingerprint {doc['fingerprint']}")
    check(doc.get("deep") is True and set(doc["omitted"]) == {"prng_ab"}, "not a deep document")
    for rec in doc["results"]:
        check("error" not in rec, f"deep record failed: {rec}")
        check(rec["value"] > 0, f"deep record not positive: {rec}")
        if rec["segment"] != "compat":
            for k in DEEP_STATS:
                check(k in rec and np.isfinite(rec[k]) and rec[k] > 0,
                      f"deep record {rec['metric']} lacks {k}: {rec}")
    calibration = doc["calibration_lidar_rooms_4096x200"]
    check(calibration > 0, f"calibration {calibration}")
    doc["seconds"] = time.perf_counter() - t0
    return doc


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the GPU", file=sys.stderr)
        return 1
    import apx_torch  # noqa: F401  (fails here when run without the repo)
    from apx_torch.bench import bench_compat, nvidia_smi_line
    from apx_torch.ops import build

    dev = torch.device("cuda")
    seconds: dict[str, float] = {}
    lap = [time.perf_counter()]

    def emit(line: str, **kwargs) -> None:
        """Print a phase's line and add the seconds since the previous
        line to its label's (the text before the first colon)."""
        print(line, **kwargs)
        now = time.perf_counter()
        label = line.split(":")[0]
        seconds[label] = seconds.get(label, 0.0) + now - lap[0]
        lap[0] = now

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit(f"device: {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
         flush=True)

    t0 = time.perf_counter()
    build.load(verbose=True)
    emit(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds():.2f} s)",
         flush=True)

    rows = phase_kernels(dev)
    emit("kernels: " + "; ".join(
        f"{r['name']} max|d|={r['max_abs_err']} " + ", ".join(
            f"R={k} {v['ms']:.4f} ms (plain {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms)"
            for k, v in r["by_r"].items()) for r in rows), flush=True)
    edge = phase_edge_casts(dev)
    emit(f"kernels: K1 bitwise on {edge} edge casts ({', '.join(EDGE_MAPS)}; R in {EDGE_RAYS}; "
         f"N={EDGE_N})", flush=True)
    for r in rows:
        r["edge_casts_checked"] = edge
    k3 = phase_glimpse_kernel(dev)
    emit(f"kernels: glimpse {json.dumps(k3['by_geometry'])}", flush=True)
    numerics_rows = phase_numerics_kernels(dev)
    emit(f"numerics kernels: {json.dumps(numerics_rows)}", flush=True)
    fused_rows = phase_lidar_step_kernels(dev)
    emit(f"lidar step kernels: {json.dumps(fused_rows)}", flush=True)
    ld_rows = phase_light_dark_kernel(dev)
    emit(f"light dark kernel: {json.dumps(ld_rows)}", flush=True)

    main_path = phase_main_path(dev)
    emit(f"main path: {json.dumps(main_path)}", flush=True)
    # S, R and F2 run on the dense main path; K1 and F1 on the window path
    # (below) and the other window backends.
    for r in rows + fused_rows:
        r["launches"] = main_path["launches"][ROW_KEYS[r["name"]]]
    emit(f"card vs cpu: {json.dumps(phase_card_vs_cpu(dev, 'LIDARLocRooms-v0', 256, 120, {}))}",
         flush=True)

    cs_path = phase_circle_square_main_path(dev)
    emit(f"circle square main path: {json.dumps(cs_path)}", flush=True)
    k3["launches"] = cs_path["launches"]["K3"]
    rows.append(k3)
    tol = {"glimpse": GLIMPSE_TOL, "reward": 1e-6}
    for env_id in ("CircleSquare-v0", "CircleSquareInverted-v0"):
        emit(f"circle square card vs cpu: {json.dumps(phase_card_vs_cpu(dev, env_id, 256, 51, tol))}",
             flush=True)

    k2, k1_window = phase_window_kernels(dev)
    emit(f"kernels: window {json.dumps(k2)}; raycast on windows {json.dumps(k1_window)}",
         flush=True)
    window = {"raycast_backend": "pallas_window"}
    window_path = phase_main_path(dev, **window)
    emit(f"window main path: {json.dumps(window_path)}", flush=True)
    for r in rows[:2]:
        r["window"] = {"launches": window_path["launches"][ROW_KEYS[r["name"]]],
                       "by_r": k1_window[r["name"]]}
    for r in fused_rows:
        r["window"] = {"launches": window_path["launches"][ROW_KEYS[r["name"]]]}
    for r in rows[:2] + fused_rows[:1]:  # K1 and F1: their launches are the window path's
        r["launches"] = window_path["launches"][ROW_KEYS[r["name"]]]
        r["launches_path"] = f"LIDARLocRooms-v0 pallas_window, N={N}, reset + " \
                             f"{window_path['steps']} steps (0 on the dense path: S and R)"
    k2["launches"] = window_path["launches"]["K2"]
    rows.append(k2)
    emit(f"window card vs cpu: "
         f"{json.dumps(phase_card_vs_cpu(dev, 'LIDARLocRooms-v0', 256, 120, {}, **window))}",
         flush=True)

    rows.append(phase_chain(dev))

    ld_path = phase_light_dark_main_path(dev)
    emit(f"light dark main path: {json.dumps(ld_path)}", flush=True)
    for r in ld_rows:
        r["launches"] = ld_path["launches"][ROW_KEYS[r["name"]]]
        r["launches_path"] = f"LightDark-v0 main path, N={N}, reset + {ld_path['steps']} steps"
    lidar_sparse = phase_sparse_metrics_path(dev, "LIDARLocRooms-sparse-v0", 250)
    emit(f"sparse metrics path: {json.dumps(lidar_sparse)}", flush=True)
    cs_sparse = phase_sparse_metrics_path(dev, "CircleSquare-sparse-v0", 51)
    emit(f"sparse metrics path: {json.dumps(cs_sparse)}", flush=True)
    for r in rows:
        for path in (lidar_sparse, cs_sparse):
            if path["launches"].get(ROW_KEYS[r["name"]]):
                r["sparse_metrics"] = {"env": path["env"],
                                       "launches": path["launches"][ROW_KEYS[r["name"]]]}
    for env_id, n, steps, tol in (
            ("LightDark-v0", 256, 120, {}),
            ("LIDARLocRooms-sparse-v0", 256, 120, {}),
            ("CircleSquare-sparse-v0", 256, 51, {"glimpse": GLIMPSE_TOL, "reward": 1e-6})):
        res = phase_card_vs_cpu(dev, env_id, n, steps, tol, metrics=env_id != "LightDark-v0")
        emit(f"step draws / wrappers card vs cpu: {json.dumps(res)}", flush=True)

    tin_path = phase_tin_loc_main_path(dev)
    emit(f"tin_loc main path: {json.dumps(tin_path)}", flush=True)
    k3["tin_loc"] = {"launches": tin_path["launches"]["K3"],
                     "geometry": k3["by_geometry"]["tiny_imagenet"]["shape"]}
    emit(f"sweep card vs cpu: {json.dumps(phase_sweep_card_vs_cpu(dev))}", flush=True)
    res = phase_card_vs_cpu(dev, "TinyImageNetLoc-v0", 64, 51, {
        "glimpse": GLIMPSE_TOL, "target_glimpse": GLIMPSE_TOL, "reward": 1e-6},
        start_from_cpu=True)
    emit(f"tin_loc card vs cpu: {json.dumps(res)}", flush=True)
    tol = {"glimpse": GLIMPSE_TOL, "reward": 1e-6}
    for env_id, geometry in (("DoubleCircleSquare-v0", None), ("MNIST-v0", "mnist"),
                             ("CIFAR10-v0", "cifar10"), ("CircleSquareHideAndSeek-v0", None),
                             ("CircleSquareHideAndSeekNoPrediction-sparse-v0", None)):
        clear_launches()
        res = phase_card_vs_cpu(dev, env_id, 256, 51, tol)
        res["glimpse_launches"] = launched("K3")
        check(res["glimpse_launches"] == 1 + 2 * 51,
              f"{env_id}: glimpse launched {res['glimpse_launches']} times, not 1 + 2 per step")
        if geometry:
            k3["by_geometry"][geometry]["launches"] = res["glimpse_launches"]
            k3["by_geometry"][geometry]["launches_path"] = f"{env_id}, N=256, 51 steps"
        emit(f"new ids card vs cpu: {json.dumps(res)}", flush=True)

    for env_id in ("LIDARLocMaze-v0", "LIDARLocRoomsStatic-v0"):
        emit(f"bench paths card vs cpu: "
             f"{json.dumps(phase_card_vs_cpu(dev, env_id, 256, 120, {}))}", flush=True)
    deep = phase_deep_capture()
    emit(f"deep capture: calibration_lidar_rooms_4096x200 "
         f"{deep['calibration_lidar_rooms_4096x200']} env-steps/s, {len(deep['results'])} "
         f"records, {deep['seconds']:.1f} s, fingerprint {json.dumps(deep['fingerprint'])}",
         flush=True)
    for rec in deep["results"]:
        emit(f"throughput: {json.dumps(rec)}", flush=True)
    workloads = phase_workload_kernels(dev)
    emit(f"workload kernels: {json.dumps(workloads)}", flush=True)
    for r in rows[:2] + [k3] + fused_rows[2:]:
        r["workloads"] = {
            name: {"num_envs": path["num_envs"], "steps": path["steps"],
                   "launches": path["launches"][ROW_KEYS[r["name"]]],
                   "launches_per_step": path["launches_per_step"][ROW_KEYS[r["name"]]],
                   **path["kernels"][r["name"]]}
            for name, path in workloads.items() if r["name"] in path["kernels"]}
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            v["max_abs_err"] for w in r["workloads"].values()
            for v in (w["by_r"].values() if "by_r" in w else [w])])

    sharded = phase_sharded_rollout("LIDARLocRooms-v0", 1, "nccl", SHARDED_STEPS)
    emit(f"sharded rollout: {json.dumps(sharded)}", flush=True)
    gloo_lidar = phase_sharded_rollout("LIDARLocRooms-v0", 2, "gloo", SHARDED_STEPS)
    emit(f"sharded rollout: {json.dumps(gloo_lidar)}", flush=True)
    gloo_cs = phase_sharded_rollout("CircleSquare-v0", 2, "gloo", EPISODIC_STEPS, period=16)
    emit(f"sharded rollout: {json.dumps(gloo_cs)}", flush=True)
    for r in rows + fused_rows:
        key = ROW_KEYS[r["name"]]
        for path in (sharded, gloo_lidar, gloo_cs):
            if launched(key, path["ranks"][0]["launches"]):
                r.setdefault("sharded", []).append({
                    "env": path["env"], "world_size": path["world_size"],
                    "backend": path["backend"], "steps": path["steps"],
                    "launches_per_rank": [launched(key, x["launches"]) for x in path["ranks"]]})
    emit(f"checkpoint: {json.dumps(phase_checkpoint(dev))}", flush=True)
    emit(f"bank rotator: {json.dumps(phase_bank_rotator(dev))}", flush=True)
    emit(f"native bank: {json.dumps(phase_native_bank(dev))}", flush=True)
    for nproc, backend in ((1, "nccl"), (2, "gloo")):
        for env in ("lidar_rooms", "circle_square"):
            res = phase_sharded_bench(env, nproc, backend)
            emit(f"sharded throughput: {json.dumps(res)}", flush=True)

    compat, compat_launches = phase_compat(dev)
    for res in compat:
        emit(f"compat card vs cpu: {json.dumps(res)}", flush=True)
    for r in rows + fused_rows:
        if ROW_KEYS[r["name"]] in compat_launches:
            r["compat"] = compat_launches[ROW_KEYS[r["name"]]]
    for env in ("lidar_rooms", "circle_square"):
        emit(f"compat throughput: {json.dumps(bench_compat(env, N))}", flush=True)
    emit("compat: the gymnasium shells (make / make_vec) and the PIL frames need gymnasium "
         "and pillow, absent here; tests/test_torch_compat*.py and test_torch_render.py "
         "cover them on the CPU", flush=True)

    emit(f"perception module: {json.dumps(phase_perception_module(dev))}", flush=True)
    study = phase_glimpse_study(dev)
    emit(f"glimpse study: {json.dumps(study)}", flush=True)
    k3["glimpse_study"] = {"launches": study["k3_launches"],
                           "geometry": f"N={study['n']} {'x'.join(map(str, study['image']))} u8 "
                                       f"and f32, 10x10, {study['reps']} chained steps",
                           "us_per_batch": {k: study["variants"][k]["us_per_batch"]
                                            for k in ("k3[u8]", "k3[f32]")},
                           "moving_us_per_batch": {k: study["variants"][k]["moving_us_per_batch"]
                                                   for k in ("k3[u8]", "k3[f32]")}}
    for line in phase_parse_trace(dev):
        emit(line, flush=True)

    backend_kernels = phase_backend_kernels(dev)
    emit(f"kernels on the backends' windows: {json.dumps(backend_kernels)}", flush=True)
    backends = phase_raycast_backends(dev)
    emit(f"raycast backends: {json.dumps(backends)}", flush=True)
    for r in rows[:2] + fused_rows:
        r["backends"] = {name: path["launches"][ROW_KEYS[r["name"]]]
                         for name, path in backends["paths"].items()}
    for r in rows[:2]:
        r["backend_windows"] = backend_kernels[r["name"]]
    samplers = phase_samplers(dev)
    emit(f"samplers: {json.dumps(samplers)}", flush=True)
    k3["chunked"] = {"launches": samplers[f"chunked_n{N}"]["glimpse_launches"],
                     "path": f"TinyImageNetLoc-v0 explicit reset, N={N}: 27 chunks + obs + target"}
    storage = phase_image_storage(dev)
    emit(f"image storage: {json.dumps(storage)}", flush=True)
    k3["storage"] = {name: path["glimpse_launches"] for name, path in storage["paths"].items()}
    k3["bank_larger_than_l2"] = storage["bank_larger_than_l2"]
    emit(f"sharded bank: {json.dumps(phase_sharded_bank(dev))}", flush=True)
    emit("class layer: the gymnasium classes (gym_classes, gym_spaces, ap_gym_alias, the "
         "spaces of perception_module), render() frames (pillow) and the tools create_env_vid, "
         "create_gifs (imageio) and mk_env_doc (gymnasium) need packages absent here; "
         "tests/test_torch_class_layer.py, test_torch_perception_module.py and "
         "test_torch_tools.py cover them on the CPU", flush=True)

    train = phase_train_ppo(dev)
    emit(f"train ppo: {json.dumps(train)}", flush=True)
    for r in (r for r in rows + fused_rows
              if ROW_KEYS[r["name"]] in train["launches_per_iteration"]):
        key = ROW_KEYS[r["name"]]
        r["train"] = {"launches_per_iteration": train["launches_per_iteration"][key],
                      "launches": [x["launches"][key] for x in train["iterations"]],
                      "path": f"train_ppo_lidar iteration, LIDARLocRooms-v0, N={TRAIN_N}, "
                              f"rollout {TRAIN_T}"}
    emit(f"train card vs cpu: {json.dumps(phase_train_card_vs_cpu(dev))}", flush=True)
    emit(f"train grid: {json.dumps(phase_train_grid(dev))}", flush=True)
    emit(f"train resume: {json.dumps(phase_train_resume())}", flush=True)
    flagship = phase_entry(dev)
    emit(f"entry: {json.dumps(flagship)}", flush=True)
    k3["max_abs_err"] = max(k3["max_abs_err"], flagship["max_abs_err"])
    k3["entry"] = {"launches": flagship["launches"], "max_abs_err": flagship["max_abs_err"],
                   "path": "graft_entry.entry(): CircleSquare 16x16, N=64, reset + one step"}

    # N1-N3 left the LIDAR step (F1, F2) and LightDark's (L): their
    # launches are TinyImageNetLoc's.
    tin_numerics = tin_path["numerics_launches"]
    for r in numerics_rows:
        key = ROW_KEYS[r["name"]]
        r["launches"] = tin_numerics[key]
        r["launches_path"] = f"TinyImageNetLoc-v0 main path, N={N}, reset + " \
                             f"{tin_path['steps']} steps"
        r["paths"] = {path: {"steps": c["steps"], "launches": c[key],
                             "per_step": c["per_step"][key]}
                      for path, c in NUMERICS_BY_PATH.items()}
    rows.extend(numerics_rows)
    rows.extend(fused_rows)
    rows.extend(ld_rows)
    print(f"phase seconds: {json.dumps(seconds)}", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--train-resume"]:
        print("RESUME " + json.dumps(train_resume_worker()), flush=True)
        sys.exit(0)
    sys.exit(main())
