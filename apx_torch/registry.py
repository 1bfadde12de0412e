"""Environment registry of the port (counterpart of apx.registry).

The port has 46 of apx's 158 ids so far, each built and autoreset as apx
builds it:

* the four LIDAR base ids, each
  ``TimeLimit(LIDARLocalizationEnv(bank), 100, issue_termination=True)``
  under NEXT_STEP autoreset;
* the 18 CircleSquare and CircleSquareInverted ids of apx's nine suffix
  families (image size, gradient, step limit), each
  ``ImageClassificationEnv(CircleSquare bank, step_limit=T)`` under
  LOCKSTEP autoreset, the Inverted ones with randomly inverted labels;
* ``LightDark-v0``, ``TimeLimit(LightDarkEnv(), 50, issue_termination=True)``
  under NEXT_STEP autoreset;
* the ``<Name>-sparse-v0`` twin of each, ``Sparsify`` over the same env.

Every other apx id raises ``KeyError``; the order in which they arrive is
ROADMAP.md's queue 1. ``make_vec(..., metrics=True)`` wraps the vector env
in ``ClassificationMetrics`` or ``RegressionMetrics`` with a buffer of the
id's step limit.

    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", num_envs=4096)
    venv, params = apx_torch.make_vec("CircleSquare-sparse-v0", num_envs=4096, metrics=True)

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .core.env import APEnv, AutoResetMode, vector_env
from .envs.image_classification import ImageClassificationEnv
from .envs.lidar_localization import LIDARLocalizationEnv
from .envs.light_dark import LightDarkEnv
from .wrappers.metrics import ClassificationMetrics, RegressionMetrics
from .wrappers.sparsify import Sparsify
from .wrappers.time_limit import TimeLimit

__all__ = ["EnvEntry", "make", "make_vec", "env_ids"]


@dataclasses.dataclass(frozen=True)
class EnvEntry:
    env_id: str
    build: Callable[[torch.device], APEnv]
    step_limit: int  # episode length bound (the metrics buffer's length)
    metrics: str  # "classification" or "regression"
    autoreset: AutoResetMode
    sparse: bool = False


_BANK_CACHE: dict = {}


def _map_bank(kind: str, static: bool, device: torch.device):
    from .data.floor_map import make_maze_bank, make_rooms_bank

    # Static variants use map index 0; dynamic ones a 256-map bank drawn
    # from bank seed 0, as in apx.
    key = (kind, static, str(device))
    if key not in _BANK_CACHE:
        mk = make_maze_bank if kind == "maze" else make_rooms_bank
        if static:
            _BANK_CACHE[key] = mk(num_maps=1, indices=[0], device=device)
        else:
            _BANK_CACHE[key] = mk(num_maps=256, device=device)
    return _BANK_CACHE[key]


def _circle_square_bank(size: int, gradient: bool, device: torch.device):
    from .data.circle_square import make_circle_square_bank

    key = ("cs", size, gradient, str(device))
    if key not in _BANK_CACHE:
        _BANK_CACHE[key] = make_circle_square_bank(
            (size, size), show_gradient=gradient, device=device
        )
    return _BANK_CACHE[key]


# apx's CircleSquare suffix families: (suffix, image size, gradient, step limit).
_CIRCLE_SQUARE_FAMILIES = [
    ("", 28, True, 16),
    ("-s28", 28, True, 16),
    ("-s20", 20, True, 16),
    ("-s15", 15, True, 16),
    ("-nograd", 28, False, 16),
    ("-s20-nograd", 20, False, 16),
    ("-s15-nograd", 15, False, 16),
    ("-t32", 28, True, 32),
    ("-t64", 28, True, 64),
]


def _register(reg: dict[str, EnvEntry], entry: EnvEntry) -> None:
    """The entry and its ``-sparse`` twin (apx/registry.py:112-117)."""
    reg[entry.env_id] = entry
    base, ver = entry.env_id.rsplit("-", 1)
    reg[f"{base}-sparse-{ver}"] = dataclasses.replace(
        entry, env_id=f"{base}-sparse-{ver}", sparse=True)


def _build_registry() -> dict[str, EnvEntry]:
    reg: dict[str, EnvEntry] = {}
    for sfx, size, grad, t in _CIRCLE_SQUARE_FAMILIES:
        for name, invert in (("CircleSquare", False), ("CircleSquareInverted", True)):
            _register(reg, EnvEntry(
                env_id=f"{name}{sfx}-v0",
                build=lambda device, size=size, grad=grad, t=t, invert=invert:
                    ImageClassificationEnv(
                        dataset=_circle_square_bank(size, grad, device), step_limit=t,
                        randomly_invert_labels=invert,
                    ),
                step_limit=t, metrics="classification", autoreset=AutoResetMode.LOCKSTEP,
            ))
    _register(reg, EnvEntry(
        env_id="LightDark-v0",
        build=lambda device: TimeLimit(LightDarkEnv(device), 50, issue_termination=True),
        step_limit=50, metrics="regression", autoreset=AutoResetMode.NEXT_STEP,
    ))
    for env_id, kind, static in [
        ("LIDARLocMazeStatic-v0", "maze", True),
        ("LIDARLocMaze-v0", "maze", False),
        ("LIDARLocRoomsStatic-v0", "rooms", True),
        ("LIDARLocRooms-v0", "rooms", False),
    ]:
        _register(reg, EnvEntry(
            env_id=env_id,
            build=lambda device, kind=kind, static=static: TimeLimit(
                LIDARLocalizationEnv(
                    map_bank=_map_bank(kind, static, device), static_map=static
                ),
                100, issue_termination=True,
            ),
            step_limit=100, metrics="regression", autoreset=AutoResetMode.NEXT_STEP,
        ))
    return reg


_REGISTRY = _build_registry()


def env_ids() -> list[str]:
    return sorted(_REGISTRY)


def _entry(env_id: str) -> EnvEntry:
    entry = _REGISTRY.get(env_id)
    if entry is None:
        raise KeyError(
            f"{env_id!r} is not ported to apx_torch yet (ported: {env_ids()}); "
            "see ROADMAP.md, queue 1"
        )
    return entry


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apx_torch runs on the GPU by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch forms"
        )
    return device


def make(env_id: str, device="cuda", **param_overrides):
    """Single functional env (batched API): returns (env, params)."""
    entry = _entry(env_id)
    env = entry.build(_device(device))
    if entry.sparse:
        env = Sparsify(env)
    return env, env.default_params(**param_overrides)


def make_vec(
    env_id: str,
    num_envs: int,
    device="cuda",
    metrics: bool = False,
    autoreset: AutoResetMode | None = None,
    **param_overrides,
):
    """Vector env: returns (venv, params). ``metrics`` wraps it in the
    id's episode-metrics wrapper (a buffer of the id's step limit)."""
    entry = _entry(env_id)
    env, params = make(env_id, device=device, **param_overrides)
    venv = vector_env(env, num_envs, autoreset or entry.autoreset)
    if metrics:
        cls = ClassificationMetrics if entry.metrics == "classification" else RegressionMetrics
        return cls(venv, buffer_len=entry.step_limit), params
    return venv, params
