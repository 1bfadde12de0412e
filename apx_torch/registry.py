"""Environment registry of the port (counterpart of apx.registry): all of
apx's 158 ids, 79 base ids and a ``<Name>-sparse-v0`` twin of each, built
and autoreset as apx builds them:

* the CircleSquare, CircleSquareInverted and DoubleCircleSquare ids of
  apx's nine suffix families (image size, gradient, step limit), each an
  ``ImageClassificationEnv`` under LOCKSTEP autoreset;
* ``CircleSquareHideAndSeek-v0`` and ``...NoPrediction-v0``: a 28x28
  CircleSquare env with a 32-step limit under LOCKSTEP, wrapped at the
  vector level in ``CircleSquareHideAndSeek`` (``make`` of these ids runs
  a one-env vector pipeline through ``VectorToSingle``);
* MNIST, CIFAR10, CIFAR10-c2 .. c10 (the first k classes) and TinyImageNet
  classification, and MNISTLoc, CIFAR10Loc and TinyImageNetLoc
  localization, each also as ``-train`` and ``-test`` (TinyImageNet's test
  split is ``"valid"``), under LOCKSTEP; TinyImageNet's sensor is 10x10;
* ``LightDark-v0``, ``TimeLimit(LightDarkEnv(), 50, issue_termination=True)``
  under NEXT_STEP autoreset;
* the four LIDAR ids, ``TimeLimit(LIDARLocalizationEnv(bank), 100,
  issue_termination=True)`` under NEXT_STEP autoreset.

The image corpora come from ``data.huggingface.load_hf_image_bank``: the
local HF cache if ``datasets`` holds them, else apx's synthetic bank of the
corpus' geometry (8192 images); nothing is downloaded. Banks are built once
per (name, split, channels, filter_labels, device); a bank built on the
card prints its kind. ``make_vec(..., metrics=True)`` wraps the vector env
in ``ClassificationMetrics`` or ``RegressionMetrics`` with a buffer of the
id's step limit, except for HideAndSeekNoPrediction, which has none.

    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", num_envs=4096)
    venv, params = apx_torch.make_vec("TinyImageNetLoc-v0", num_envs=4096)

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable

import torch

from .core.env import APEnv, AutoResetMode, VectorAPEnv, vector_env
from .envs.circle_square_hide_and_seek import CircleSquareHideAndSeek
from .envs.image_classification import ImageClassificationEnv
from .envs.image_localization import ImageLocalizationEnv
from .envs.lidar_localization import LIDARLocalizationEnv
from .envs.light_dark import LightDarkEnv
from .wrappers.metrics import ClassificationMetrics, RegressionMetrics
from .wrappers.sparsify import Sparsify
from .wrappers.time_limit import TimeLimit
from .wrappers.vector_to_single import VectorToSingle

__all__ = ["EnvEntry", "make", "make_vec", "env_ids"]


@dataclasses.dataclass(frozen=True)
class EnvEntry:
    env_id: str
    build: Callable[[torch.device], APEnv]
    step_limit: int  # episode length bound (the metrics buffer's length)
    metrics: str | None  # "classification", "regression" or None
    autoreset: AutoResetMode
    vector_wrapper: Callable[[VectorAPEnv], Any] | None = None  # HideAndSeek
    sparse: bool = False


# apx's render settings of the HF image envs (render-only fields).
_RENDER_KW = dict(render_unvisited_opacity=0.5, render_visited_opacity=0.25)

_BANK_CACHE: dict = {}


def _cached(key, make):
    if key not in _BANK_CACHE:
        _BANK_CACHE[key] = make()
    return _BANK_CACHE[key]


def _map_bank(kind: str, static: bool, device: torch.device):
    from .data.floor_map import make_maze_bank, make_rooms_bank

    # Static variants use map index 0; dynamic ones a 256-map bank drawn
    # from bank seed 0, as in apx.
    mk = make_maze_bank if kind == "maze" else make_rooms_bank
    if static:
        return _cached((kind, static, str(device)),
                       lambda: mk(num_maps=1, indices=[0], device=device))
    return _cached((kind, static, str(device)), lambda: mk(num_maps=256, device=device))


def _circle_square_bank(size: int, gradient: bool, device: torch.device):
    from .data.circle_square import make_circle_square_bank

    return _cached(("cs", size, gradient, str(device)), lambda: make_circle_square_bank(
        (size, size), show_gradient=gradient, device=device))


def _double_circle_square_ds(size: int, gradient: bool, device: torch.device):
    from .data.circle_square import DoubleCircleSquareDataset

    return _cached(("dcs", size, gradient, str(device)), lambda: DoubleCircleSquareDataset.create(
        (size, size), show_gradient_a=gradient, show_gradient_b=gradient, device=device))


def _hf_bank(name: str, split: str, device: torch.device, channels=None,
             image_feature_name="image", filter_labels=None):
    from .data.huggingface import load_hf_image_bank

    def make():
        bank = load_hf_image_bank(name, split=split, channels=channels,
                                  image_feature_name=image_feature_name,
                                  filter_labels=filter_labels, device=device)
        if device.type == "cuda":
            print(f"apx_torch: {name} {split} bank: {bank.bank_kind}, {bank.length} images "
                  f"of {bank.image_shape}", file=sys.stderr, flush=True)
        return bank

    return _cached(("hf", name, split, channels, tuple(filter_labels or ()), str(device)), make)


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


def _hf_specs():
    """(id stem, bank arguments, env arguments) of apx's HF image ids:
    classification first, then localization."""
    from .data.huggingface import CIFAR10_CLASSES

    tiny = dict(sensor_size=(10, 10), **_RENDER_KW)
    classification = [
        ("MNIST", dict(name="mnist", channels=1), {}),
        ("CIFAR10", dict(name="cifar10", image_feature_name="img"), _RENDER_KW),
        *[(f"CIFAR10-c{i}", dict(name="cifar10", image_feature_name="img",
                                 filter_labels=list(CIFAR10_CLASSES[:i])), _RENDER_KW)
          for i in range(2, 11)],
        ("TinyImageNet", dict(name="zh-plus/tiny-imagenet"), tiny),
    ]
    localization = [
        ("MNISTLoc", dict(name="mnist", channels=1), _RENDER_KW),
        ("CIFAR10Loc", dict(name="cifar10", image_feature_name="img"), _RENDER_KW),
        ("TinyImageNetLoc", dict(name="zh-plus/tiny-imagenet"), tiny),
    ]
    return ([(*s, ImageClassificationEnv, "classification") for s in classification]
            + [(*s, ImageLocalizationEnv, "regression") for s in localization])


def _build_registry() -> dict[str, EnvEntry]:
    reg: dict[str, EnvEntry] = {}
    lockstep = AutoResetMode.LOCKSTEP
    for sfx, size, grad, t in _CIRCLE_SQUARE_FAMILIES:
        for name, invert in (("CircleSquare", False), ("CircleSquareInverted", True)):
            _register(reg, EnvEntry(
                env_id=f"{name}{sfx}-v0",
                build=lambda device, size=size, grad=grad, t=t, invert=invert:
                    ImageClassificationEnv(
                        dataset=_circle_square_bank(size, grad, device), step_limit=t,
                        randomly_invert_labels=invert,
                    ),
                step_limit=t, metrics="classification", autoreset=lockstep,
            ))
        _register(reg, EnvEntry(
            env_id=f"DoubleCircleSquare{sfx}-v0",
            build=lambda device, size=size, grad=grad, t=t: ImageClassificationEnv(
                dataset=_double_circle_square_ds(size, grad, device), step_limit=t),
            step_limit=t, metrics="classification", autoreset=lockstep,
        ))
    for env_id, mask in (("CircleSquareHideAndSeek-v0", False),
                         ("CircleSquareHideAndSeekNoPrediction-v0", True)):
        _register(reg, EnvEntry(
            env_id=env_id,
            build=lambda device: ImageClassificationEnv(
                dataset=_circle_square_bank(28, True, device), step_limit=32),
            step_limit=32, metrics=None if mask else "classification", autoreset=lockstep,
            vector_wrapper=lambda v, mask=mask: CircleSquareHideAndSeek(v, mask_prediction=mask),
        ))
    for stem, bank_kw, env_kw, cls, metrics in _hf_specs():
        for split_sfx, split in (("", "train"), ("-train", "train"), ("-test", "test")):
            if bank_kw["name"] == "zh-plus/tiny-imagenet" and split == "test":
                split = "valid"
            _register(reg, EnvEntry(
                env_id=f"{stem}{split_sfx}-v0",
                build=lambda device, bank_kw=bank_kw, env_kw=env_kw, cls=cls, split=split:
                    cls(dataset=_hf_bank(split=split, device=device, **bank_kw), **env_kw),
                step_limit=16, metrics=metrics, autoreset=lockstep,
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
        raise KeyError(f"Unknown env id: {env_id!r}. Known: {len(_REGISTRY)} ids.")
    return entry


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apx_torch runs on the GPU by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch forms"
        )
    return device


def _build(entry: EnvEntry, device, param_overrides):
    env = entry.build(_device(device))
    if entry.sparse:
        env = Sparsify(env)
    return env, env.default_params(**param_overrides)


def make(env_id: str, device="cuda", **param_overrides):
    """Single functional env (batched API): returns (env, params). A
    vector-wrapped id (HideAndSeek) gives ``VectorToSingle`` over a one-env
    ``make_vec``, as apx does."""
    entry = _entry(env_id)
    if entry.vector_wrapper is not None:
        venv, params = make_vec(env_id, 1, device=device, **param_overrides)
        return VectorToSingle(venv), params
    return _build(entry, device, param_overrides)


def make_vec(
    env_id: str,
    num_envs: int,
    device="cuda",
    metrics: bool = False,
    autoreset: AutoResetMode | None = None,
    **param_overrides,
):
    """Vector env: returns (venv, params). ``metrics`` wraps it in the
    id's episode-metrics wrapper (a buffer of the id's step limit), where
    the id has one."""
    entry = _entry(env_id)
    env, params = _build(entry, device, param_overrides)
    out: Any = vector_env(env, num_envs, autoreset or entry.autoreset)
    if entry.vector_wrapper is not None:
        out = entry.vector_wrapper(out)
    if metrics and entry.metrics is not None:
        cls = ClassificationMetrics if entry.metrics == "classification" else RegressionMetrics
        out = cls(out, buffer_len=entry.step_limit)
    return out, params
