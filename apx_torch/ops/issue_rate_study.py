"""The issue-rate study on the card: what does a per-env 16-wide tile cost
against full-width registers? (Counterpart of apx.ops.issue_rate_study.)

The identical loop-carried slab combine chain (the ~16-operation
max/min/compare/select sequence of the untyped slab cast, loop-carried so
nothing can be hoisted) runs ``iters`` rounds per element in K4
(``apx_torch/csrc/issue_rate_study.cu``), in two layouts that differ only
in how many lanes of each warp carry an element:

- ``wide``: (rows, 128) inputs, consecutive elements on consecutive
  threads, every warp full;
- ``narrow``: (rows, 16) inputs, one row per warp, lanes 16-31 idle — the
  layout of the port's K1 on a 16-column window (one lane per column).

``issue_penalty`` = useful ops/s (wide) / useful ops/s (narrow). Useful
ops count the elements carried (rows x lanes), so the narrow figure
charges its idle lanes to the layout. The wide layout's share of the
card's float32 issue rate (SMs x 128 float32 lanes x the maximum SM clock,
read from the device and from nvidia-smi, an FMA counting as one
operation) checks the method.

    python -m apx_torch.ops.issue_rate_study

prints one JSON object with both layouts, the penalty, the rate it was
held to, ``device_kind`` and the power limit. It runs on the card only.

``chain_cuda`` launches K4 on CUDA tensors or raises, and runs the plain
form ``chain_body`` on CPU tensors; ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import json

import torch

from . import build

__all__ = ["CHAIN_OPS_PER_ELEM", "LANES", "chain_body", "chain_cuda", "measure", "issue_rate",
           "LAUNCHES", "reset_launch_counts"]

# Ops per element per iteration of the chain (2 mul, 2 sub, 1 add at the
# tail + 3 max, 3 min, 2 compare, 1 and, 1 select, and the x update's
# multiply and add = 16). Every op consumes the loop-carried x.
CHAIN_OPS_PER_ELEM = 16
LANES = {"wide": 128, "narrow": 16}
_LAYOUT_ID = {"wide": 0, "narrow": 1}

LAUNCHES: dict[str, int] = {"chain": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def chain_body(nx, ny, fx, fy, occ, iters: int) -> torch.Tensor:
    """The loop-carried chain in apx's order (``_chain_body``); returns the
    final accumulator plus x, shaped like nx. The plain form of K4."""
    one = torch.ones((), dtype=nx.dtype, device=nx.device)
    acc = torch.zeros_like(nx)
    x = torch.full_like(nx, 0.25)
    for _ in range(iters):
        a = torch.maximum(torch.maximum(x, nx), torch.maximum(x * 0.5, ny))
        b = torch.minimum(torch.minimum(fx - x, one), torch.minimum(fy, one - x))
        valid = (occ > x) & (a <= b)
        t = torch.where(valid, a, b)
        acc = acc + t
        x = t * 0.25 + 0.125  # exact as one FMA too: t * 0.25 is exact
    return acc + x


def _check(args, layout: str) -> None:
    if layout not in _LAYOUT_ID:
        raise ValueError(f"layout must be one of {sorted(_LAYOUT_ID)}, got {layout!r}")
    shape, dev = args[0].shape, args[0].device
    if len(shape) != 2 or any(a.shape != shape for a in args):
        raise ValueError("expected five (rows, lanes) inputs of one shape")
    if any(a.dtype != torch.float32 or a.device != dev for a in args):
        raise TypeError("expected float32 inputs on one device")
    if layout == "narrow" and shape[1] > 32:
        raise ValueError(f"the narrow layout puts one row in a warp: lanes <= 32, got {shape[1]}")


def chain_cuda(nx, ny, fx, fy, occ, iters: int, layout: str = "wide") -> torch.Tensor:
    """K4 over (rows, lanes) float32 inputs in ``layout`` ("wide" or
    "narrow"); the plain ``chain_body`` for CPU tensors."""
    args = (nx, ny, fx, fy, occ)
    _check(args, layout)
    if nx.device.type == "cpu":
        return chain_body(*args, iters)
    lib = build.load()
    args = tuple(a.contiguous() for a in args)
    rows, lanes = nx.shape
    out = torch.empty_like(args[0])
    err = lib.chain_launch(*(a.data_ptr() for a in args), out.data_ptr(), rows, lanes,
                           int(iters), _LAYOUT_ID[layout],
                           torch.cuda.current_stream(nx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain kernel launch failed: CUDA error {err}")
    LAUNCHES["chain"] += 1
    return out


def issue_rate(device=0) -> dict:
    """The card's float32 issue rate: SMs x 128 float32 lanes x maximum SM
    clock (nvidia-smi ``clocks.max.sm``), an FMA counting as one op."""
    from ..bench import nvidia_smi_line

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(nvidia_smi_line("clocks.max.sm").split()[0])
    return {"sms": sms, "max_sm_clock_mhz": mhz, "fp32_lanes_per_sm": 128,
            "gops_per_s": sms * 128 * mhz * 1e6 / 1e9}


def measure(rows: int = 4096, iters: int = 512, reps: int = 20, seed: int = 0) -> dict:
    """Time both layouts on the card (CUDA events over ``reps`` launches
    after a warmup launch); each rep's output is the next rep's nx, as in
    apx, so the reps form a data-dependent sequence."""
    if not torch.cuda.is_available():
        raise RuntimeError("the issue-rate study measures the GPU and no CUDA device is available")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: dict = {}
    for name, lanes in LANES.items():
        args = [torch.rand((rows, lanes), generator=gen, device=dev) for _ in range(5)]
        r = chain_cuda(*args, iters=iters, layout=name)  # warm
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            args[0] = r
            r = chain_cuda(*args, iters=iters, layout=name)
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3 / reps
        ops = rows * lanes * iters * CHAIN_OPS_PER_ELEM
        out[name] = {"lanes": lanes, "time_us": dt * 1e6, "useful_gops_per_s": ops / dt / 1e9}
    out["issue_penalty"] = out["wide"]["useful_gops_per_s"] / out["narrow"]["useful_gops_per_s"]
    rate = issue_rate(dev)
    out["fp32_issue_rate"] = rate
    out["wide_issue_rate_frac"] = out["wide"]["useful_gops_per_s"] / rate["gops_per_s"]
    out.update(rows=rows, iters=iters, reps=reps)
    return out


def main() -> None:
    from ..bench import nvidia_smi_line

    res = measure()
    res["device_kind"] = torch.cuda.get_device_name(0)
    res["nvidia_smi"] = nvidia_smi_line()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
