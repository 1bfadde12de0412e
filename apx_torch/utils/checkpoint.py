"""Checkpoint / resume for env state (counterpart of apx.utils.checkpoint).

The reference has no checkpointing; here env state is a tree of tensors,
so a learner that checkpoints mid-rollout can resume its envs bitwise.
Any tree of the port's states works: dataclasses (``VectorState``, the
envs' states, ``MetricsState`` with its ring buffers), dicts, tuples,
lists and ``None``; add a generator's ``get_state()`` as a leaf to resume
its draws too.

The file (``torch.save``) holds the tensor leaves in tree order and a
structure descriptor made of plain containers and strings, and is loaded
with ``weights_only=True``, which refuses dataclasses: the tree is rebuilt
from ``like``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from ..core.env import tree_map

__all__ = ["save_state", "restore_state"]


def _describe(tree) -> Any:
    """The tree's structure as plain containers: its node kinds, dataclass
    names, keys, and each leaf's shape and dtype."""
    if tree is None:
        return ["none"]
    if isinstance(tree, torch.Tensor):
        return ["tensor", list(tree.shape), str(tree.dtype)]
    if isinstance(tree, dict):
        return ["dict", [[k, _describe(v)] for k, v in tree.items()]]
    if isinstance(tree, (tuple, list)):
        return [type(tree).__name__, [_describe(v) for v in tree]]
    if dataclasses.is_dataclass(tree):
        cls = type(tree)
        return ["dataclass", f"{cls.__module__}.{cls.__qualname__}",
                [[f.name, _describe(getattr(tree, f.name))] for f in dataclasses.fields(tree)]]
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def _leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _first_difference(saved, want, path: str = "state") -> str:
    """Where two descriptors differ, in words."""
    if saved[0] != want[0]:
        return f"{path}: saved a {saved[0]}, expected a {want[0]}"
    kind = saved[0]
    if kind == "tensor":
        if saved[1] != want[1]:
            return f"{path}: saved shape {tuple(saved[1])}, expected {tuple(want[1])}"
        return f"{path}: saved dtype {saved[2]}, expected {want[2]}"
    if kind == "dataclass" and saved[1] != want[1]:
        return f"{path}: saved a {saved[1]}, expected a {want[1]}"
    items_s, items_w = saved[-1], want[-1]
    if kind in ("dict", "dataclass"):
        keys_s, keys_w = [k for k, _ in items_s], [k for k, _ in items_w]
        if keys_s != keys_w:
            return f"{path}: saved keys {keys_s}, expected {keys_w}"
        for (k, s), (_, w) in zip(items_s, items_w):
            if s != w:
                return _first_difference(s, w, f"{path}.{k}")
        return f"{path}: differs"
    if len(items_s) != len(items_w):
        return f"{path}: saved {len(items_s)} entries, expected {len(items_w)}"
    for i, (s, w) in enumerate(zip(items_s, items_w)):
        if s != w:
            return _first_difference(s, w, f"{path}[{i}]")
    return f"{path}: differs"


def save_state(path: str, state: Any) -> None:
    """Write an env-state tree (or any tree of tensors) to ``path``."""
    torch.save({"structure": _describe(state),
                "leaves": [t.detach().cpu() for t in _leaves(state)]},
               os.path.abspath(path))


def restore_state(path: str, like: Any) -> Any:
    """Restore a tree saved by ``save_state``. ``like`` (the live state
    being replaced, or one of its shape) supplies the structure; the saved
    structure, shapes and dtypes must equal its, else ValueError. Each
    leaf lands on the device of ``like``'s leaf."""
    saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    want = _describe(like)
    if saved["structure"] != want:
        raise ValueError(f"checkpoint {path} does not match the state it restores: "
                         f"{_first_difference(saved['structure'], want)}")
    leaves = iter(saved["leaves"])
    return tree_map(lambda x: next(leaves).to(x.device), like)
