"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size: for each seed, a short run of the cell (its window, its
checked chunks) and the check's numbers for the program; for the control
seeds also the control's, the reference computed in the precision below
the configuration's (bfloat16 for float32) put in the program's place.

    python3 -m benchmark.control --workload <cell> --seconds 3 --warm 1 \\
        --seeds S1 ... S12 --control-seeds S1 S2 S3

prints one JSON line per seed: ``{"seed", "program", "control"}``, each a
dict of the compared numbers (``control`` null where not read). The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import manifest
from .run import _caches, _log

__all__ = ["CONTROL_DTYPES", "main"]

# The precision below each stated precision.
CONTROL_DTYPES = {"float32": torch.bfloat16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--warm", type=float, default=None,
                    help="seconds of warm replays (default: the mix's); the check reads "
                         "no rate")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    _caches()
    cell = manifest.cell(manifest.load(), args.workload)
    if args.warm is not None:
        cell["traffic"] = {**cell["traffic"], "warm_seconds": args.warm}
    if not torch.cuda.is_available():
        _log("the control reads the card and no CUDA device is available")
        return 2
    low = CONTROL_DTYPES[cell["config"]["precision"]]
    for seed in args.seeds:
        got = cell["kind"].run(cell, seed % 2**63, args.seconds, False, time.perf_counter(), _log,
                               torch.device("cuda"),
                               control=low if seed in args.control_seeds else None)
        print(json.dumps({"seed": seed, "program": got["compared"], "control": got["control"],
                          "problems": got["problems"], "window": got["window"]}), flush=True)
        del got
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
