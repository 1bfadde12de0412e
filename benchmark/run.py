"""One run of one cell of the port's benchmark, on the card it is started on.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It measures ``apx_torch`` (the PyTorch and
CUDA port) and nothing else: it exits with code 2 and prints no result
without a CUDA device (or with fewer cards than the cell asks for), and
with code 3 if a module of JAX or of the JAX package is loaded once the
window has closed.

Its last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; last, ``compared``: each number the check compared,
with its limit. Those numbers are also the last lines of standard error.

Build and kernel caches stay inside the checkout (the port builds its
kernels into ``apx_torch/_build/``; Triton's and PyTorch's extension caches
go to ``.bench_cache/``); a trace is written under ``TMPDIR`` and deleted.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import manifest  # noqa: E402
from .yardstick import guard, trace as tr  # noqa: E402

__all__ = ["main", "result"]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _caches() -> None:
    cache = manifest.ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def _per_layer(cell: dict, ctx: dict) -> dict:
    out = {}
    for m in cell["per_layer"]:
        value = manifest.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(cell: dict, got: dict, traced: bool, device: dict) -> dict:
    """The run's result line from the kind's readings ``got``."""
    limits = cell["check"]["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in got["compared"].items()}
    correct = not got["problems"] and all(c["value"] <= c["limit"] for c in compared.values())
    if traced:
        ctx = got["per_layer"]
        metrics = _per_layer(cell, ctx)
        trace = ctx["trace"]
        device = {**device, "busy_s": tr.busy_us(trace) * 1e-6,
                  "window_s": ctx["traced_wall_s"]}
    else:
        metrics = {}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": float(got["e2e"][m["name"]]), "unit": m["unit"]}
    out = {"correct": correct, "attempted": got["attempted"], "failed": got["failed"],
           "metrics": metrics, "device": device}
    if traced:
        out["breakdown"] = {
            "device_ops": [[name, us * 1e-6] for name, us in tr.top_ops(trace, 10)],
            "idle_gaps": [[name, us * 1e-6] for name, us in tr.idle_gaps(trace, 10)]}
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"the cell needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    got = cell["kind"].run(cell, args.seed % 2**63, args.seconds, bool(args.trace), T0, _log,
                           torch.device("cuda"))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(got["memory_peak_bytes"])}
    out = result(cell, got, bool(args.trace), device)
    loaded = guard.forbidden_loaded()
    if loaded:
        _log(f"modules of JAX or of the JAX package are loaded: {', '.join(loaded)}")
        return 3
    window = got["window"]
    _log(f"window {window['seconds']:.3f} s, {window['chunks']} chunks, {window['steps']} steps, "
         f"checked chunks {window['checked']} in {window['check_s']:.3f} s; set-up {got['e2e']['setup_s']:.3f} s")
    for problem in got["problems"]:
        _log(problem)
    for name, c in out["compared"].items():
        _log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
