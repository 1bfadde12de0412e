"""Measured study of glimpse layouts on the card (counterpart of
apx.ops.glimpse_study, at its geometry).

apx's study asked, on its TPU, which form of the batched bilinear glimpse
to run: the dense GEMM (``extract_glimpse_batch``) at three matmul
precisions, a 2-row + 2-col tap gather (``tap2``), a uint8 bank against a
pre-converted float32 bank, and uint8 row gathers against the same bytes
packed as int32. Its verdicts were the TPU's; this module asks the same
questions of the H100, with the port's hand-written kernel K3
(``glimpse_cuda.glimpse``) among the forms and ``grid_sample`` as the
library line. Geometry as apx's: N=4096 images of 64x64x3 (TinyImageNet),
a 10x10 sensor, REPS=32 chained steps in which each step's glimpse moves
the next position.

apx's chain moves a position by at most 1e-3 per step, so every step
reads the footprints the first one read: on the card they stay in its
50 MB L2. Each variant is therefore timed three ways (each run captured
once in a CUDA graph and replayed, CUDA events, microseconds per batch of
N glimpses):

* ``us_per_batch``: apx's chain;
* ``moving_us_per_batch``: the chain with each step moving the position
  by the envs' ``max_step_length`` (``MOVE`` = 0.2 per axis, wrapped into
  [-1, 1)), so each glimpse reads lines the previous one did not;
* ``alone_us_per_batch``: REPS independent calls on the same inputs, as
  ``chip_smoke.py`` times the kernels (no position update).

The chains' own cost per step (the position update, with a constant
glimpse) is ``chain_overhead_us`` and ``moving_chain_overhead_us``.

Variants:

* ``k3[u8]``, ``k3[f32]``: K3 over the uint8 bank and over the bank
  pre-converted to float32 (x / 255);
* ``gemm[highest|high|default]``: the plain form over the uint8 bank at
  apx's three precisions (fp32 with TF32 off, TF32, bfloat16 inputs), and
  ``gemm[highest, f32 bank]``;
* ``tap2[u8]``: ``tap2_glimpse``, the tap gather in torch;
* ``grid_sample[f32]``: one ``torch.nn.functional.grid_sample`` on the
  float32 NCHW bank at the same coordinates (the library line; the port
  never calls it);
* the row gather of a 60,000-row MNIST-shaped bank (4096 rows per step,
  REPS chained), uint8[784] against int32[196].

Each glimpse variant's max |error| against a float64 oracle (the plain
form's products in float64 at the same float32 coordinates) is reported,
and K3 and ``tap2`` are held within 1e-5 of the fp32 plain form, as apx
holds ``tap2``.

    python -m apx_torch.ops.glimpse_study   # on the card; raises without one

The functions take a device, so the tests run them small on the CPU,
where nothing is timed (``us_per_batch`` is None: a CPU run gives no
device time).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..core.numerics import div
from . import glimpse_cuda
from ._launch import launched
from .glimpse import extract_glimpse_batch, glimpse_coords, interp_weights

__all__ = ["tap2_glimpse", "oracle_glimpse", "glimpse_variants", "chain_us", "alone_us",
           "gather_us", "run_study", "main", "N", "H", "W", "C", "S", "REPS", "MOVE", "TOL"]

N, H, W, C = 4096, 64, 64, 3
S = (10, 10)
REPS = 32
MOVE = 0.2  # the envs' max_step_length (normalized units per axis)
GATHER_ROWS, GATHER_BYTES = 60_000, 784
TOL = 1e-5  # K3 and tap2 against the fp32 plain form


def tap2_glimpse(images: torch.Tensor, pos_norm: torch.Tensor,
                 sensor_size: tuple[int, int] = S, sensor_scale: float = 1.0) -> torch.Tensor:
    """Bilinear glimpse via 2-row + 2-col tap gathers, batched (apx's
    ``tap2_glimpse`` per image, ``apx/ops/glimpse_study.py:68-91``): the
    two rows each sample row touches, blended by their hat weights, then
    the two columns each sample column touches."""
    n, h, w, _ = images.shape
    rows, cols = glimpse_coords(pos_norm, (h, w), sensor_size, sensor_scale)
    rc = rows.clamp(0.0, float(h - 1))
    cc = cols.clamp(0.0, float(w - 1))
    r0 = rc.floor().clamp(0, h - 1).long()
    r1 = (r0 + 1).clamp(max=h - 1)
    c0 = cc.floor().clamp(0, w - 1).long()
    c1 = (c0 + 1).clamp(max=w - 1)
    wr0 = torch.clamp_min(1.0 - (rc - r0.float()).abs(), 0.0)
    wr1 = torch.where(r1 == r0, 0.0, torch.clamp_min(1.0 - (rc - r1.float()).abs(), 0.0))
    wc0 = torch.clamp_min(1.0 - (cc - c0.float()).abs(), 0.0)
    wc1 = torch.where(c1 == c0, 0.0, torch.clamp_min(1.0 - (cc - c1.float()).abs(), 0.0))
    env = torch.arange(n, device=images.device)[:, None]
    row0, row1 = images[env, r0].float(), images[env, r1].float()  # (N, s0, W, C)
    if images.dtype == torch.uint8:
        row0, row1 = div(row0, 255.0), div(row1, 255.0)
    rblend = row0 * wr0[..., None, None] + row1 * wr1[..., None, None]
    srow = torch.arange(rows.shape[1], device=images.device)[None, :, None]
    col0 = rblend[env[..., None], srow, c0[:, None, :]]  # (N, s0, s1, C)
    col1 = rblend[env[..., None], srow, c1[:, None, :]]
    out = col0 * wc0[:, None, :, None] + col1 * wc1[:, None, :, None]
    return out.clamp(0.0, 1.0)


def oracle_glimpse(images: torch.Tensor, pos_norm: torch.Tensor,
                   sensor_size: tuple[int, int] = S, sensor_scale: float = 1.0) -> torch.Tensor:
    """The plain form's products in float64, at its float32 coordinates."""
    _, h, w, _ = images.shape
    rows, cols = glimpse_coords(pos_norm, (h, w), sensor_size, sensor_scale)
    w_rows = interp_weights(rows, h).double()
    w_cols = interp_weights(cols, w).double()
    img = images.double()
    if images.dtype == torch.uint8:
        img = img / 255.0
    tmp = torch.einsum("nsh,nhwc->nswc", w_rows, img)
    return torch.einsum("nswc,ntw->nstc", tmp, w_cols).clamp(0.0, 1.0)


def _grid_sample_fn(sensor_size, sensor_scale):
    """The library line: grid_sample on the float32 NCHW bank (converted
    once, outside the timing) at the glimpse's coordinates."""

    def fn(nchw: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        n, _, h, w = nchw.shape
        rows, cols = glimpse_coords(pos, (h, w), sensor_size, sensor_scale)
        grid = torch.stack(torch.broadcast_tensors(
            (cols / (w - 1) * 2 - 1)[:, None, :], (rows / (h - 1) * 2 - 1)[:, :, None]), dim=-1)
        out = F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                            align_corners=True)
        return out.permute(0, 2, 3, 1).clamp(0.0, 1.0)

    return fn


def glimpse_variants(images_u8: torch.Tensor, sensor_size=S, sensor_scale: float = 1.0) -> dict:
    """name -> (bank, fn(bank, pos) -> (N, s0, s1, C) float32 glimpses)."""
    f32 = images_u8.float() / 255.0
    nchw = f32.permute(0, 3, 1, 2).contiguous()

    def gemm(precision):
        return lambda b, p: extract_glimpse_batch(b, p, sensor_size, sensor_scale,
                                                  precision=precision)

    k3 = lambda b, p: glimpse_cuda.glimpse(b, p, sensor_size, sensor_scale)  # noqa: E731
    return {
        "k3[u8]": (images_u8, k3),
        "k3[f32]": (f32, k3),
        "gemm[highest]": (images_u8, gemm("highest")),
        "gemm[high]": (images_u8, gemm("high")),
        "gemm[default]": (images_u8, gemm("default")),
        "gemm[highest, f32 bank]": (f32, gemm("highest")),
        "tap2[u8]": (images_u8, lambda b, p: tap2_glimpse(b, p, sensor_size, sensor_scale)),
        "grid_sample[f32]": (nchw, _grid_sample_fn(sensor_size, sensor_scale)),
    }


def _chain(fn, bank, pos0: torch.Tensor, reps: int, move: float | None = None):
    """``reps`` glimpses, each moving the next position by its first two
    values: by at most 1e-3 per axis (apx's scan body) or, given ``move``,
    by ``+-move`` per axis (the sign from the value), wrapped into [-1, 1).
    Returns the final positions."""
    pos = pos0
    n = pos0.shape[0]
    for _ in range(reps):
        d = fn(bank, pos).reshape(n, -1)[:, :2]
        if move is None:
            pos = (pos + d * 1e-3 - 5e-4).clamp(-1.0, 1.0)
        else:
            pos = torch.remainder(pos + torch.where(d >= 0.5, move, -move) + 1.0, 2.0) - 1.0
    return pos


def _graph_us(run, reps: int, replays: int = 5) -> float:
    """Microseconds per step of ``run`` (``reps`` steps) on the card: the
    run captured in one CUDA graph, replayed, timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / (replays * reps)


def chain_us(fn, bank, pos0: torch.Tensor, reps: int = REPS,
             move: float | None = None) -> float | None:
    """Microseconds per batch of the ``reps``-step glimpse chain of ``fn``
    (``_chain``) on the card (None on the CPU, where the chain runs once
    untimed)."""
    if bank.device.type != "cuda":
        _chain(fn, bank, pos0, reps, move)
        return None
    return _graph_us(lambda: _chain(fn, bank, pos0, reps, move), reps)


def alone_us(fn, bank, pos: torch.Tensor, reps: int = REPS) -> float | None:
    """Microseconds per call of ``fn`` on the card over ``reps``
    independent calls on the same inputs (None on the CPU, where it runs
    once untimed)."""
    if bank.device.type != "cuda":
        fn(bank, pos)
        return None

    def run():
        for _ in range(reps):
            fn(bank, pos)

    return _graph_us(run, reps)


def _gather_chain(bank: torch.Tensor, idx0: torch.Tensor, reps: int) -> torch.Tensor:
    idx = idx0
    d = bank.shape[0]
    for _ in range(reps):
        r = bank[idx]
        idx = (idx + r[:, 0].long() + 1) % d
    return idx


def gather_us(rows: np.ndarray, device, n: int = N, reps: int = REPS) -> dict:
    """Row-gather chain of ``n`` rows per step from the uint8 bank
    ``rows`` (D, B) and from the same bytes as int32 (D, B / 4): microseconds
    per step of each on the card (None on the CPU), and whether the
    gathered bytes agree."""
    u8 = torch.as_tensor(rows, device=device)
    i32 = torch.as_tensor(np.ascontiguousarray(rows).view(np.int32), device=device)
    idx0 = torch.as_tensor(np.random.default_rng(0).integers(0, len(rows), n), device=device)
    same = bool((u8[idx0].view(torch.int32) == i32[idx0]).all())
    out = {"rows": len(rows), "gathered_per_step": n, "same_bytes": same}
    for name, bank in (("u8", u8), ("i32", i32)):
        if u8.device.type == "cuda":
            out[f"{name}_us"] = _graph_us(lambda b=bank: _gather_chain(b, idx0, reps), reps)
        else:
            _gather_chain(bank, idx0, reps)
            out[f"{name}_us"] = None
    return out


def run_study(device, n: int = N, hw: tuple[int, int] = (H, W), c: int = C,
              sensor_size: tuple[int, int] = S, reps: int = REPS,
              gather_rows: int = GATHER_ROWS, gather_bytes: int = GATHER_BYTES,
              seed: int = 0) -> dict:
    """Every variant at (n, hw, c, sensor_size): its max |error| against the
    float64 oracle and against the fp32 plain form, and its microseconds
    per batch on the card in apx's chain, in the moving chain and alone;
    the chains' own costs per step; then the row gathers. Raises if K3 or
    tap2 is off the fp32 plain form by more than ``TOL``. K3's launches in
    the study are ``k3_launches`` (``ops._launch``'s count: the eager checks,
    and of each timed run the warmup and the captured one; graph replays
    re-run the captured launches without the wrapper)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    images = torch.as_tensor(rng.integers(0, 255, (n, *hw, c), dtype=np.uint8), device=device)
    pos = torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32), device=device)
    launches0 = launched("K3")
    oracle = oracle_glimpse(images, pos, sensor_size)
    fp32 = extract_glimpse_batch(images, pos, sensor_size, precision="highest")
    variants = {}
    for name, (bank, fn) in glimpse_variants(images, sensor_size).items():
        got = fn(bank, pos)
        variants[name] = {
            "max_abs_err_vs_f64": float((got.double() - oracle).abs().max()),
            "max_abs_err_vs_fp32_plain": float((got - fp32).abs().max()),
            "us_per_batch": chain_us(fn, bank, pos, reps),
            "moving_us_per_batch": chain_us(fn, bank, pos, reps, MOVE),
            "alone_us_per_batch": alone_us(fn, bank, pos, reps),
        }
    # The chains' own cost per step (the position update), with a glimpse
    # that is a constant tensor: subtract it for a variant's glimpse alone.
    const = torch.zeros_like(fp32)
    overhead_us = chain_us(lambda b, p: const, images, pos, reps)
    moving_overhead_us = chain_us(lambda b, p: const, images, pos, reps, MOVE)
    for name in ("k3[u8]", "k3[f32]", "tap2[u8]"):
        err = variants[name]["max_abs_err_vs_fp32_plain"]
        if not err < TOL:
            raise RuntimeError(f"{name}: max |diff| {err} against the fp32 plain form > {TOL}")
    gather = gather_us(rng.integers(0, 255, (gather_rows, gather_bytes), dtype=np.uint8),
                       device, n, reps)
    if not gather["same_bytes"]:
        raise RuntimeError("int32 row gather disagrees with the uint8 one")
    return {"device": str(device), "n": n, "image": [*hw, c], "sensor": list(sensor_size),
            "reps": reps, "move": MOVE, "variants": variants,
            "chain_overhead_us": overhead_us, "moving_chain_overhead_us": moving_overhead_us,
            "row_gather": gather,
            "k3_launches": launched("K3") - launches0}


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the glimpse study measures the GPU and no CUDA device is available")
    from ..bench import nvidia_smi_line

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    res = run_study("cuda")
    res["seconds"] = time.perf_counter() - t0
    res["device_kind"] = torch.cuda.get_device_name(0)
    res["nvidia_smi"] = nvidia_smi_line()
    print(f"{'us/batch':>24}: {'apx chain':>10} {'moving':>10} {'alone':>10}", flush=True)
    for name, v in res["variants"].items():
        print(f"{name:>24}: {v['us_per_batch']:10.2f} {v['moving_us_per_batch']:10.2f} "
              f"{v['alone_us_per_batch']:10.2f}, max |err| vs f64 "
              f"{v['max_abs_err_vs_f64']:.2e}", flush=True)
    print(f"{'chain overhead':>24}: {res['chain_overhead_us']:10.2f} "
          f"{res['moving_chain_overhead_us']:10.2f} us/step", flush=True)
    g = res["row_gather"]
    print(f"row gather {g['rows']}-row bank: u8[784] {g['u8_us']:.2f} us, "
          f"i32[196] {g['i32_us']:.2f} us", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
