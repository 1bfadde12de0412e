"""Make ``import ap_gym`` resolve to the port's compat layer (counterpart
of apx.compat.ap_gym_alias).

Lets scripts written against the reference (e.g. its example/*.py) run
unmodified on the port:

    import apx_torch.compat.ap_gym_alias  # installs the alias
    import ap_gym
    env = ap_gym.make("CircleSquare-v0")  # on the card; device="cpu" for the CPU

The alias exposes the reference's FULL ``__init__`` export list (the
reference's ap_gym/__init__.py:1-47): make/make_vec/register, the env base
classes (subclassable, with the reference's step templates), the
ensure/restore/pseudo machinery, wrapper classes (TimeLimit, Sparsify,
VectorToSingle, log wrappers), ImageSpace/LogitSpace, and the loss-class
hierarchy — all backed by the port's implementations, and the
``ap_gym.envs.*`` submodule tree. The loss classes have ``numpy()`` and
``torch()``; their ``jax()`` raises ``NotImplementedError`` (the port
imports no JAX; ``apx.compat``'s alias has it). It needs gymnasium.
"""

from __future__ import annotations

import sys
import types

__all__ = ["install"]


def _build_loss_classes():
    from ..core import losses as L
    from .loss_adapter import CompatLossFn

    class LossFn(CompatLossFn):
        """Reference-shaped base (loss_fn.py:25-83); constructible from a
        port loss (``apx_torch.core.losses``) for subclass-style use."""

    class CrossEntropyLossFn(CompatLossFn):
        def __init__(self, num_classes: int | None = None):
            super().__init__(L.CrossEntropyLossFn(num_classes=num_classes))

    class MSELossFn(CompatLossFn):
        def __init__(self, target_std=None):
            super().__init__(L.MSELossFn(target_std=target_std))

    class ZeroLossFn(CompatLossFn):
        def __init__(self):
            super().__init__(L.ZeroLossFn())

    class WeightedLossFn(CompatLossFn):
        def __init__(self, inner):
            if isinstance(inner, CompatLossFn):
                inner = inner.inner
            super().__init__(L.WeightedLossFn(inner=inner))

    class LambdaLossFn(CompatLossFn):
        """User callables with the reference signature
        fn(prediction, target, batch_shape) (loss_fn.py:140-181). ``jax``
        is accepted and never called: ``jax()`` raises, as on every loss
        of the port."""

        def __init__(
            self,
            np=None,
            torch=None,
            jax=None,
            lower_bound=float("-inf"),
            blind_guessing_expected_value=None,
        ):
            self._np_fn, self._torch_fn = np, torch
            super().__init__(
                L.LambdaLossFn(
                    fn=(lambda p, t: torch(p, t, ())) if torch else None,
                    numpy_fn=(lambda p, t: np(p, t, ())) if np else None,
                    lower_bound_value=lower_bound,
                    blind_guess_value=blind_guessing_expected_value,
                )
            )

        def numpy(self, prediction, target, batch_shape=()):
            if self._np_fn is None:
                raise NotImplementedError
            return self._np_fn(prediction, target, batch_shape)

        def torch(self, prediction, target, batch_shape=()):
            if self._torch_fn is None:
                raise NotImplementedError
            return self._torch_fn(prediction, target, batch_shape)

    class LossFnAffineTransformation(CompatLossFn):
        def __init__(self, inner, scale=1.0, offset=0.0):
            if isinstance(inner, CompatLossFn):
                inner = inner.inner
            super().__init__(L.AffineLossFn(inner=inner, scale=scale, offset=offset))

    return {
        "LossFn": LossFn,
        "CrossEntropyLossFn": CrossEntropyLossFn,
        "MSELossFn": MSELossFn,
        "ZeroLossFn": ZeroLossFn,
        "WeightedLossFn": WeightedLossFn,
        "LambdaLossFn": LambdaLossFn,
        "LossFnAffineTransformation": LossFnAffineTransformation,
    }


def _make_user_registry(apc, gym_classes):
    """Minimal user-facing register/make machinery mirroring
    registration.py:87-142: custom entry points become AP envs via
    ensure_*, and every id gets a '<name>-sparse' twin at the same
    version (derived via gymnasium's parse_env_id/get_env_id, like the
    reference — so MyEnv-v3 gets MyEnv-sparse-v3)."""
    from gymnasium.envs.registration import get_env_id, parse_env_id

    user_registry: dict[str, dict] = {}

    def register(id: str, entry_point=None, kwargs=None, additional_wrappers=(), **_):
        user_registry[id] = {
            "entry_point": entry_point,
            "kwargs": dict(kwargs or {}),
            "wrappers": tuple(additional_wrappers),
        }

    def _sparse_base_id(env_id: str) -> str | None:
        """Registered base id for a '<name>-sparse' id of any version."""
        try:
            ns, name, version = parse_env_id(env_id)
        except Exception:
            return None
        if not name.endswith("-sparse"):
            return None
        base = get_env_id(ns, name[: -len("-sparse")], version)
        return base if base in user_registry else None

    def _build_user(spec, extra_kwargs):
        env = spec["entry_point"](**{**spec["kwargs"], **extra_kwargs})
        for w in spec["wrappers"]:
            # gymnasium WrapperSpec-alikes: resolve by terminal class name
            # against the alias surface (TimeLimit etc.).
            name = getattr(w, "name", None)
            wkw = dict(getattr(w, "kwargs", {}) or {})
            cls = getattr(sys.modules.get("ap_gym"), name, None) if name else None
            if cls is None:
                raise ValueError(f"Cannot resolve wrapper spec {w!r}")
            env = cls(env, **wkw)
        return env

    def make(env_id: str, **kwargs):
        if env_id in user_registry:
            env = _build_user(user_registry[env_id], kwargs)
            return gym_classes.ensure_active_perception_env(env)
        base_id = _sparse_base_id(env_id)
        if base_id is not None:
            env = _build_user(user_registry[base_id], kwargs)
            return gym_classes.SparsifyWrapper(env)
        return apc.make(env_id, **kwargs)

    def make_vec(env_id: str, num_envs: int = 1, **kwargs):
        import gymnasium as gym

        def _sync_vec(spec):
            return gym.vector.SyncVectorEnv(
                [lambda: _build_user(spec, kwargs) for _ in range(num_envs)]
            )

        if env_id in user_registry:
            env = _sync_vec(user_registry[env_id])
            return gym_classes.ensure_active_perception_vector_env(env)
        base_id = _sparse_base_id(env_id)
        if base_id is not None:
            env = gym_classes.ensure_active_perception_vector_env(
                _sync_vec(user_registry[base_id])
            )
            return gym_classes.SparsifyVectorWrapper(env)
        return apc.make_vec(env_id, num_envs=num_envs, **kwargs)

    return register, make, make_vec


def install(name: str = "ap_gym") -> types.ModuleType:
    from .. import compat as apc
    from . import gym_classes as G
    from .log import (
        ClassificationLogWrapper,
        RegressionLogWrapper,
        VectorClassificationLogWrapper,
        VectorRegressionLogWrapper,
    )

    mod = types.ModuleType(name)
    register, make, make_vec = _make_user_registry(apc, G)
    mod.make = make
    mod.make_vec = make_vec
    mod.register = register
    mod.register_envs = lambda: None  # the port's registry is always loaded

    # Core API classes (active_perception_env.py / ..._vector_env.py).
    for cls_name in (
        "ActivePerceptionActionSpace",
        "NoActivePerceptionEnvError",
        "BaseActivePerceptionEnv",
        "ActivePerceptionEnv",
        "ActivePerceptionWrapper",
        "ActivePerceptionRestoreWrapper",
        "PseudoActivePerceptionWrapper",
        "ensure_active_perception_env",
        "BaseActivePerceptionVectorEnv",
        "ActivePerceptionVectorEnv",
        "ActivePerceptionVectorWrapper",
        "ActivePerceptionVectorRestoreWrapper",
        "PseudoActivePerceptionVectorWrapper",
        "ensure_active_perception_vector_env",
        "ActiveClassificationEnv",
        "ActiveClassificationVectorEnv",
        "ActiveRegressionEnv",
        "ActiveRegressionVectorEnv",
        "ImageSpace",
        "LogitSpace",
        "TimeLimit",
        "SparsifyWrapper",
        "SparsifyVectorWrapper",
        "VectorToSingleWrapper",
        "ActivePerceptionVectorToSingleWrapper",
    ):
        setattr(mod, cls_name, getattr(G, cls_name))

    # Log wrappers under the reference names.
    mod.ActiveClassificationLogWrapper = ClassificationLogWrapper
    mod.ActiveRegressionLogWrapper = RegressionLogWrapper
    mod.ActiveClassificationVectorLogWrapper = VectorClassificationLogWrapper
    mod.ActiveRegressionVectorLogWrapper = VectorRegressionLogWrapper

    for k, v in _build_loss_classes().items():
        setattr(mod, k, v)

    def idoc(obj, doc):  # util.py:89-91
        try:
            obj.__idoc__ = doc
        except AttributeError:
            pass
        return obj

    mod.idoc = idoc
    # Drop stale submodule entries (e.g. from a previously-imported real
    # reference) so the alias tree below is authoritative for `name`.
    for stale in [k for k in sys.modules if k.startswith(name + ".")]:
        del sys.modules[stale]
    _materialize_envs_tree(mod)
    mod.__apx_alias__ = True  # lets tooling tell an alias from the real thing
    mod.__apx_torch_alias__ = True  # and this alias from apx's
    sys.modules[name] = mod
    return mod


def _materialize_envs_tree(mod: types.ModuleType) -> None:
    """Register the reference's ``ap_gym.envs.*`` submodule surface so
    reference-style imports (``from ap_gym.envs.image import
    CircleSquareDataset``) work on the alias. Export lists mirror the
    reference's ap_gym/envs/{__init__,image/__init__,dataset/__init__,
    floor_map/__init__}.py."""
    from ..data.stream import (
        BufferedIterator,
        DataLoader,
        DatasetBatchIterator,
        DatasetIterator,
    )
    from . import dataset_classes as DC
    from .perception_module import ImagePerceptionConfig, ImagePerceptionModule

    def _submodule(fullname: str, **attrs) -> types.ModuleType:
        m = types.ModuleType(fullname)
        for key, value in attrs.items():
            setattr(m, key, value)
        sys.modules[fullname] = m
        return m

    envs = _submodule(mod.__name__ + ".envs")
    envs.dataset = _submodule(
        envs.__name__ + ".dataset",
        Dataset=DC.Dataset,
        DataLoader=DataLoader,
        DatasetIterator=DatasetIterator,
        DatasetBatchIterator=DatasetBatchIterator,
        BufferedIterator=BufferedIterator,
    )
    envs.image = _submodule(
        envs.__name__ + ".image",
        HuggingfaceImageClassificationDataset=DC.HuggingfaceImageClassificationDataset,
        ImageClassificationDataset=DC.ImageClassificationDataset,
        CircleSquareDataset=DC.CircleSquareDataset,
        DoubleCircleSquareDataset=DC.DoubleCircleSquareDataset,
        ImagePerceptionModule=ImagePerceptionModule,
        ImagePerceptionConfig=ImagePerceptionConfig,
    )
    envs.floor_map = _submodule(
        envs.__name__ + ".floor_map",
        FloorMapDataset=DC.FloorMapDataset,
        FloorMapDatasetRooms=DC.FloorMapDatasetRooms,
        FloorMapDatasetMaze=DC.FloorMapDatasetMaze,
    )
    mod.envs = envs


if "ap_gym" not in sys.modules:
    install()
