"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, env by env.

An env departs from the reference when any of its floating outputs differs
by more than ``tol`` (absolute; the outputs are of order one: positions in
map cells, normalized readings, rewards summed over a chunk), or any of its
integer or boolean outputs differs at all. A NaN departs. The number a run
is judged by is the share of the envs compared that depart."""

from __future__ import annotations

import torch

__all__ = ["departures"]


def departures(program: dict, reference: dict, tol: float) -> tuple[torch.Tensor, dict]:
    """(N,) bool, True where an env departs, and per output name the count
    of departing envs and the largest floating gap (inf for a NaN), over the
    outputs ``reference`` names (each with the env axis first)."""
    out, report = None, {}
    for key, ref in reference.items():
        prog = program[key].to(ref.device)
        n = ref.shape[0]
        if ref.is_floating_point() or prog.is_floating_point():
            gap = (prog.to(torch.float64) - ref.to(torch.float64)).abs().reshape(n, -1)
            bad = ~(gap <= tol).all(-1)
            gap = torch.nan_to_num(gap, nan=float("inf"))
            widest = float(gap.max()) if gap.numel() else 0.0
        else:
            bad = (prog.to(torch.int64) != ref.to(torch.int64)).reshape(n, -1).any(-1)
            widest = None
        report[key] = {"departing": int(bad.sum()), "widest": widest}
        out = bad if out is None else out | bad
    return out, report
