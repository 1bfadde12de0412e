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

K4 runs the iteration loop unrolled by a compile-time factor, with two
independent elements per thread interleaved (the kernel's source note).

    python -m apx_torch.ops.issue_rate_study [--sass FILE]

prints one JSON object with both layouts, the penalty, the rate it was
held to, ``device_kind`` and the power limit. It runs on the card only.
``--sass FILE`` instead reads FILE (``-`` for stdin), the text that
``cuobjdump -sass`` prints for the built kernel library, and prints what
the compiler made of one chain iteration (``sass_loop_counts``): the
instructions of each chain kernel's main loop by class, per chain
iteration, beside the 16 operations that ``CHAIN_OPS_PER_ELEM`` prices.
It needs no card.

``chain_cuda`` launches K4 on CUDA tensors or raises, and runs the plain
form ``chain_body`` on CPU tensors; ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from . import build
from ._launch import launch

__all__ = ["CHAIN_OPS_PER_ELEM", "LANES", "chain_body", "chain_cuda", "measure", "issue_rate",
           "LAUNCHES", "reset_launch_counts", "sass_loop_counts"]

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
    err = launch("K4", lib.chain_launch, *(a.data_ptr() for a in args), out.data_ptr(), rows,
                 lanes, int(iters), _LAYOUT_ID[layout],
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


# SASS opcodes by the part of the chain they carry out; others are "other".
# The chain does no integer work, so integer adds and compares in its loop
# (per-thread or uniform) are the loop's own.
SASS_CLASSES = {
    "FMNMX": "min/max", "FSETP": "compare", "FSEL": "select", "SEL": "select",
    "PLOP3": "predicate logic", "FADD": "add/mul/fma", "FMUL": "add/mul/fma",
    "FFMA": "add/mul/fma", "IADD3": "loop control", "VIADD": "loop control",
    "UIADD3": "loop control", "ISETP": "loop control", "UISETP": "loop control",
    "BRA": "loop control",
}
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_TARGET = re.compile(r"\bBRA\S*\s+`?\(?(\.L_x_\d+|0x[0-9a-f]+)\)?")


def _opcode(instr: str) -> str:
    """Base opcode of one SASS instruction: predicate guard and modifiers
    dropped (``@!P0 FSETP.GT.AND P0, ...`` -> ``FSETP``)."""
    words = instr.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0]


def sass_loop_counts(sass: str, kernel: str = "chain_kernel") -> dict:
    """Instructions per chain iteration in the main loop of every function
    of ``cuobjdump -sass`` text whose name contains ``kernel``.

    A loop is a backward branch to a label or an address; the main loop is
    the one with the most FFMA (every chain iteration issues exactly one,
    the x update), and each class count is divided by its FFMA count.
    Functions are keyed "wide" / "narrow" by chain_kernel's template
    argument."""
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)", sass, re.S):
        if kernel not in name:
            continue
        instrs, targets = [], {}  # targets: label or address -> instruction index
        for line in body.splitlines():
            m = _SASS_LABEL.match(line)
            if m:
                targets[m.group(1)] = len(instrs)
                continue
            m = _SASS_INSTR.search(line)
            if m:
                targets[f"0x{int(m.group(1), 16):x}"] = len(instrs)
                instrs.append(m.group(2))
        loops = []
        for end, ins in enumerate(instrs):
            m = _SASS_TARGET.search(ins)
            if m is None or _opcode(ins) != "BRA":
                continue
            key = m.group(1)
            start = targets.get(f"0x{int(key, 16):x}" if key.startswith("0x") else key)
            if start is not None and start <= end:
                loops.append([_opcode(x) for x in instrs[start:end + 1]])
        if not loops:
            raise ValueError(f"no loop in the SASS of {name}")
        body_ops = max(loops, key=lambda ops: ops.count("FFMA"))
        iters = body_ops.count("FFMA")
        by_class: dict[str, int] = {}
        for op in body_ops:
            cls = SASS_CLASSES.get(op, "other")
            by_class[cls] = by_class.get(cls, 0) + 1
        layout = "narrow" if "ILb1E" in name else "wide"
        out[layout] = {
            "function": name,
            "loop_instructions": len(body_ops),
            "chain_iterations_per_loop_trip": iters,
            "per_iteration": {k: v / iters for k, v in sorted(by_class.items())},
            "instructions_per_iteration": len(body_ops) / iters,
            "opcodes_per_iteration": {op: body_ops.count(op) / iters for op in sorted(set(body_ops))},
        }
    return out


def main(argv=None) -> None:
    from ..bench import nvidia_smi_line

    ap = argparse.ArgumentParser(description="K4's issue-rate study on the card")
    ap.add_argument("--sass", type=argparse.FileType("r"), metavar="FILE",
                    help="print the chain's SASS counts from FILE (cuobjdump -sass text) instead")
    args = ap.parse_args(argv)
    if args.sass is not None:
        print(json.dumps({"ops_priced_per_iteration": CHAIN_OPS_PER_ELEM,
                          **sass_loop_counts(args.sass.read())}))
        return
    res = measure()
    res["device_kind"] = torch.cuda.get_device_name(0)
    res["nvidia_smi"] = nvidia_smi_line()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
