"""F2, the NEXT_STEP merge with the MSE loss and reward, as one hand-written
CUDA launch (``apx_torch/csrc/merge.cu``).

``next_step`` takes and returns what ``apx_torch.ops.merge.next_step``
does, bitwise. ``VectorAPEnv.step`` sends every NEXT_STEP step here, and
this is where the merge is chosen, on the operands' device and the loss:

* on CPU tensors, the plain form (``ops.merge``);
* on CUDA tensors with a loss that ``core.losses.mse_terms`` describes
  (``MSELossFn``, or an ``AffineLossFn`` over one: LIDAR, LightDark), the
  kernel (the library is built on first use, ``apx_torch.ops.build``), or
  an error: a leaf whose step and reset tensors differ in shape, dtype or
  device, more than 32 leaves, a derived obs of a leaf that is not bool,
  an operand on another device, or a base reward or target that requires
  grad (the kernel's only gradient is the one in the prediction: detach
  the action) raises, and nothing falls back. Leaves are read in place
  when contiguous (a strided one is copied first);
* on CUDA tensors with any other loss (the ``-sparse`` ids' weighted
  loss, cross-entropy, zero), the plain form, N1-N3 at its rounding
  sites: the kernel computes the MSE loss only.

The loss and the reward are differentiable in the prediction through
``loss_cuda.LossReward``, whose backward is the plain form's gradient: it
runs ``core.losses.masked_loss_and_reward`` again on the saved operands
and differentiates it, so the gradient is the plain path's bitwise (N1's
``_FMA`` backward included).

The host builds the by-value leaf table once per tree structure (leaf
sizes and word widths, ``_PLANS``) and writes only the pointers per call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.env import tree_map
from ..core.losses import LossFn, masked_loss_and_reward, mse_terms
from . import merge
from ._launch import entry
from .loss_cuda import LossReward
from .merge import Merged

__all__ = ["next_step", "MAX_LEAVES"]

MAX_LEAVES = 32  # merge.cu's kMaxLeaves
THREADS = 256  # merge.cu's kThreads


class _Leaf(ctypes.Structure):
    _fields_ = [("step", ctypes.c_void_p), ("reset", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("words", ctypes.c_int64), ("width", ctypes.c_int32),
                ("first_block", ctypes.c_int32)]


class _Leaves(ctypes.Structure):
    _fields_ = [("leaf", _Leaf * MAX_LEAVES), ("count", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _Map(ctypes.Structure):
    _fields_ = [("step", ctypes.c_void_p), ("reset", ctypes.c_void_p),
                ("out_leaf", ctypes.c_void_p), ("out_obs", ctypes.c_void_p),
                ("cells", ctypes.c_int64), ("divisor", ctypes.c_float), ("vec4", ctypes.c_int32),
                ("first_block", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _Terms(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "mask", "base_reward", "terminated", "truncated", "prediction", "target", "t",
        "base_out", "terminated_out", "truncated_out", "done_out", "loss_out", "reward_out",
        "t_out", "time_out")] + [(name, ctypes.c_int32) for name in (
            "n", "d", "limit", "issue_termination", "fused_sum", "affine", "contract",
            "first_block")] + [(name, ctypes.c_float) for name in (
                "inv_limit", "scale", "offset", "k")]


_MERGE = entry("F2", "merge_next_step_launch", [_Leaves, _Map, _Terms])


def _blocks(work: int) -> int:
    return -(-work // THREADS)


def _width(nbytes: int, *ptrs: int) -> int:
    """The widest word (16, 8, 4, 2, 1 bytes) dividing the bytes per env
    and every pointer."""
    for w in (16, 8, 4, 2):
        if nbytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def next_step(mask: torch.Tensor, step: tuple, reset: tuple, base_reward: torch.Tensor,
              terminated: torch.Tensor, truncated: torch.Tensor, prediction, target,
              loss_fn: LossFn, derived: dict[str, tuple[str, float]] | None = None,
              counter=None) -> Merged:
    """``merge.next_step``: the kernel on the card for an MSE loss, else
    the plain form (see the module docstring)."""
    args = (mask, step, reset, base_reward, terminated, truncated, prediction, target, loss_fn,
            derived, counter)
    terms = None
    if mask.device.type != "cpu" and isinstance(prediction, torch.Tensor) and prediction.ndim == 2:
        terms = mse_terms(loss_fn, prediction.shape[-1])
    if terms is None:
        return merge.next_step(*args)
    if torch.is_grad_enabled() and (base_reward.requires_grad or target.requires_grad):
        raise ValueError("merge: the base reward or the prediction target requires grad; the "
                         "kernel differentiates the prediction only: detach the action")
    return _launch(*args, terms)


class _Plan:
    """The leaf table of one tree structure: words, widths and first
    blocks set, pointers written per call (``_table``)."""

    def __init__(self, n: int, sizes: list[tuple[int, int]], map_cells: int | None,
                 map_vec4: bool):
        self.leaves = _Leaves()
        block = 0
        for i, (nbytes, w) in enumerate(sizes):
            self.leaves.leaf[i] = _Leaf(None, None, None, nbytes // w, w, block)
            block += _blocks(n * (nbytes // w))
        self.leaves.count = len(sizes)
        self.map_block = block
        if map_cells is not None:
            block += _blocks(n * (map_cells // 4 if map_vec4 else map_cells))
        self.env_block = block


_PLANS: dict[tuple, _Plan] = {}


def _table(key: tuple, n: int, sizes, map_cells, map_vec4, ptrs) -> tuple[_Leaves, _Plan]:
    """A copy of the cached ``_Plan``'s table with this call's pointers."""
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _Plan(n, sizes, map_cells, map_vec4)
    leaves = _Leaves.from_buffer_copy(plan.leaves)
    for leaf, (step, reset, out) in zip(leaves.leaf, ptrs):
        leaf.step, leaf.reset, leaf.out = step, reset, out
    return leaves, plan


def _launch(mask, step, reset, base_reward, terminated, truncated, prediction, target, loss_fn,
            derived, counter, terms) -> Merged:
    n, dev = mask.shape[0], mask.device
    vec = dict(base_reward=(base_reward, torch.float32), terminated=(terminated, torch.bool),
               truncated=(truncated, torch.bool), mask=(mask, torch.bool))
    if counter is not None:
        vec["t"] = (counter.t, torch.int32)
    for name, (x, dtype) in vec.items():
        if x.shape != (n,) or x.dtype != dtype or x.device != dev:
            raise ValueError(f"merge: {name} must be ({n},) {dtype} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    for name, x in (("prediction", prediction), ("target", target)):
        if x.shape != (n, terms.d) or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"merge: {name} must be ({n}, {terms.d}) float32 on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    mask, base_reward, terminated, truncated = (x.contiguous() for x in
                                                (mask, base_reward, terminated, truncated))
    target = target.detach().contiguous()

    (s_obs, s_state, s_info), (r_obs, r_state, r_info) = step, reset
    map_reset = map_spec = None
    if derived:
        if len(derived) > 1:
            raise ValueError(f"merge: one derived obs entry at most, got {sorted(derived)}")
        (key, (field, divisor)), = derived.items()
        map_reset, map_step = getattr(r_state, field), getattr(s_state, field)
        if map_reset.dtype != torch.bool or map_step.dtype != torch.bool:
            raise ValueError(f"merge: derived obs {key!r} needs a bool state leaf {field!r}")
        map_spec = (key, divisor)

    # One walk over every (reset, step) leaf pair of obs, state, info: the
    # output leaf, and the table's sizes and pointers (the derived map's
    # leaf goes to the map segment instead).
    sizes, ptrs, keep = [], [], []  # keep: the tensors whose pointers the launch reads
    found = {}

    def select(r, s):
        if r.shape != s.shape or r.dtype != s.dtype or r.device != dev or s.device != dev:
            raise ValueError(f"merge: a leaf's step {tuple(s.shape)} {s.dtype} on {s.device} "
                             f"and reset {tuple(r.shape)} {r.dtype} on {r.device} differ")
        if r.ndim < 1 or r.shape[0] != n:
            raise ValueError(f"merge: leaf of shape {tuple(r.shape)} has no env axis of {n}")
        out = torch.empty_like(r, memory_format=torch.contiguous_format)
        if r is map_reset and "map" not in found:
            found["map"] = (r.contiguous(), s.contiguous(), out)
            return out
        nbytes = r.numel() // n * r.element_size() if n else 0
        if nbytes == 0:
            return out
        if len(sizes) == MAX_LEAVES:
            raise ValueError(f"merge: more than {MAX_LEAVES} leaves")
        r, s = r.contiguous(), s.contiguous()
        keep.append((r, s))
        p = (s.data_ptr(), r.data_ptr(), out.data_ptr())
        sizes.append((nbytes, _width(nbytes, *p)))
        ptrs.append(p)
        return out

    outs = [tree_map(select, r, s) for r, s in ((r_obs, s_obs), (r_state, s_state),
                                                (r_info, s_info))]
    if map_reset is not None and "map" not in found:
        raise ValueError(f"merge: derived obs leaf {derived} is not a leaf of the state")

    pmap = _Map()
    derived_obs, map_cells, map_vec4 = None, None, False
    if map_reset is not None:
        r, s, map_out = found["map"]
        map_cells = r.numel() // n if n else 0
        obs_out = torch.empty(tuple(r.shape) + (1,), dtype=torch.float32, device=dev)
        map_vec4 = map_cells % 4 == 0 and all(x.data_ptr() % 4 == 0 for x in (r, s, map_out))
        derived_obs = {map_spec[0]: obs_out}
    elif derived is not None:
        derived_obs = {}
    plan_key = (n, tuple(sizes), map_cells, map_vec4)
    leaves, plan = _table(plan_key, n, sizes, map_cells, map_vec4, ptrs)
    if map_reset is not None:
        pmap = _Map(s.data_ptr(), r.data_ptr(), map_out.data_ptr(), obs_out.data_ptr(),
                    map_cells, ctypes.c_float(map_spec[1]), int(map_vec4), plan.map_block, 0)

    # The per-env outputs, as rows of two allocations.
    observe = counter is not None and counter.observe
    f32 = torch.empty((3 + observe, n), dtype=torch.float32, device=dev).unbind(0)
    flags = torch.empty((3, n), dtype=torch.bool, device=dev).unbind(0)
    res = {"base": f32[0], "loss": f32[1], "reward": f32[2], "terminated": flags[0],
           "truncated": flags[1], "done": flags[2],
           "t": None if counter is None else torch.empty_like(counter.t),
           "time_obs": f32[3] if observe else None}
    t_in = None if counter is None else counter.t.contiguous()
    inv_limit = 0.0 if counter is None else float(np.float32(1.0) / np.float32(counter.limit))
    pred = prediction.detach().contiguous()

    def launch():
        pterms = _Terms(
            mask.data_ptr(), base_reward.data_ptr(), terminated.data_ptr(), truncated.data_ptr(),
            pred.data_ptr(), target.data_ptr(), _ptr(t_in), res["base"].data_ptr(),
            res["terminated"].data_ptr(), res["truncated"].data_ptr(), res["done"].data_ptr(),
            res["loss"].data_ptr(), res["reward"].data_ptr(), _ptr(res["t"]),
            _ptr(res["time_obs"]), n, terms.d, 0 if counter is None else counter.limit,
            int(counter is not None and counter.issue_termination), int(terms.fused_sum),
            int(terms.affine), int(terms.contract), plan.env_block, inv_limit, terms.scale,
            terms.offset, terms.k)
        _MERGE(dev, leaves, pmap, pterms)
        return res["loss"], res["reward"]

    if torch.is_grad_enabled() and prediction.requires_grad:
        loss, reward = LossReward.apply(  # res["base"]: the launch's masked base reward
            prediction, launch,
            lambda p: masked_loss_and_reward(loss_fn, mask, res["base"], p, target))
    else:
        loss, reward = launch()
    return Merged(*outs, derived_obs, res["base"], res["terminated"], res["truncated"],
                  res["done"], loss, reward, res["t"], res["time_obs"])
