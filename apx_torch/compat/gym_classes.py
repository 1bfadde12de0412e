"""Host-side gymnasium class layer: the reference's public class API
(counterpart of apx.compat.gym_classes).

The reference's L1/L2 surface is a pure-Python gymnasium class hierarchy
(active_perception_env.py, active_perception_vector_env.py,
active_classification_env.py, active_regression_env.py, time_limit.py,
sparsify_wrapper.py, vector_to_single_wrapper.py, image_space.py,
logit_space.py). User code written against the reference subclasses and
constructs these directly, so the drop-in alias
(``apx_torch.compat.ap_gym_alias``) needs real classes with the same
names, ctor signatures and step/reset semantics — not just
``make``/``make_vec``.

The structure is apx's: one shared step composer (``_compose_step``)
drives both the single and vector step templates (parameterized by batch
shape and info-merge policy, the two observable differences); the
derived-space accessors are ``_subspace`` descriptors; the wrapper override
pattern is a ``_fallthrough`` property factory; the restore wrappers pin
their resolved attributes through a ``_pinned`` descriptor; the
single/vector AP-env searches share one iterative ``_unwrap_chain``
walker; and the pseudo wrappers share a ``_PseudoPredictionChannel``
mixin. Behavioral citations are to the reference's ap_gym/<file>:<lines>.

These classes are plain host Python (like the reference's) over the
port's losses (``compat.loss_adapter.CompatLossFn``): they exist for
interop with user gym code, and need gymnasium. The device path is the
functional ``apx_torch`` API + the ``apx_torch.compat`` adapters; envs
produced by ``apx_torch.compat.make(_vec)`` pass through
``ensure_active_perception_env`` untouched because they duck-type the
active-perception surface.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from contextlib import contextmanager
from typing import Any

import gymnasium as gym
import numpy as np

from ..core import losses as L
from .gym_spaces import ActivePerceptionActionSpace, ImageSpace, LogitSpace
from .loss_adapter import CompatLossFn

__all__ = [
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
    "find_loss_and_pred_space",
    "find_loss_and_pred_space_vec",
    "zero_loss_fn",
    "cross_entropy_loss_fn",
    "mse_loss_fn",
    "weighted_loss_fn",
]


# ---------------------------------------------------------------------------
# Loss facades (reference ctor surface over the port's losses)


def zero_loss_fn() -> CompatLossFn:
    return CompatLossFn(L.ZeroLossFn())


def cross_entropy_loss_fn(num_classes: int) -> CompatLossFn:
    """CrossEntropyLossFn(num_classes=K) (loss_fn.py:207-250)."""
    return CompatLossFn(L.CrossEntropyLossFn(num_classes=num_classes))


def mse_loss_fn(target_std=None) -> CompatLossFn:
    return CompatLossFn(L.MSELossFn(target_std=target_std))


def weighted_loss_fn(inner) -> CompatLossFn:
    if isinstance(inner, CompatLossFn):
        inner = inner.inner
    return CompatLossFn(L.WeightedLossFn(inner=inner))


def _as_compat_loss(loss) -> CompatLossFn:
    return loss if isinstance(loss, CompatLossFn) else CompatLossFn(loss)


# ---------------------------------------------------------------------------
# Shared machinery


class NoActivePerceptionEnvError(ValueError):
    pass


def _is_ap(obj) -> bool:
    """Duck-typed active-perception check: covers both these classes and
    the device-backed adapters in apx_torch.compat.gym_env."""
    return hasattr(obj, "loss_fn") and hasattr(obj, "prediction_target_space")


def _is_vec_ap(obj) -> bool:
    """Vector envs additionally carry the single_* space variants."""
    return _is_ap(obj) and hasattr(obj, "single_prediction_target_space")


class _subspace:
    """Descriptor for the derived-space accessors: reads key ``key`` of the
    composite space stored under attribute ``attr`` (so e.g.
    ``prediction_space`` is always ``action_space["prediction"]``)."""

    def __init__(self, attr: str, key: str):
        self._attr, self._key = attr, key

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, self._attr)[self._key]


def _fallthrough(name: str):
    """Wrapper attribute policy: an explicit override stored in the ``_name``
    slot wins; otherwise the wrapped env's value shows through. Subclasses
    (e.g. Sparsify) install overrides by assigning the slot."""
    slot = "_" + name

    def _get(self):
        override = getattr(self, slot)
        return override if override is not None else getattr(self.env, name)

    return property(_get)


class _pinned:
    """Attribute frozen at construction time via :func:`_pin`. Reads return
    the pinned value; ordinary assignment is ignored (gymnasium's
    VectorWrapper.__init__ writes action_space/single_action_space, which
    must not clobber the restored spaces)."""

    def __set_name__(self, owner, name):
        self._slot = "_pin_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            return obj.__dict__[self._slot]
        except KeyError:
            raise AttributeError(self._slot) from None

    def __set__(self, obj, value):
        pass


def _pin(obj, **values) -> None:
    for name, value in values.items():
        obj.__dict__["_pin_" + name] = value


class _DelegateToInner:
    """Attribute fallback to the wrapped env, as the reference's restore
    wrappers do (active_perception_env.py:206-210)."""

    def __getattr__(self, item):
        try:
            return super().__getattribute__(item)
        except AttributeError:
            return getattr(self.env, item)


def _compose_step(env, full_action, *, batch_shape, merge_info):
    """The active-perception step template, shared by both env variants.

    Runs ``env._step``, evaluates the prediction loss, and folds it into
    the reward (``base_reward - loss``) and the info dict. The two
    observable differences between the reference's single and vector
    templates are parameters here:

    - ``batch_shape``: ``()`` for single envs, ``(num_envs,)`` for vector
      envs (loss broadcasting).
    - ``merge_info``: the single template REBUILDS info from scratch,
      discarding ``_step``'s own keys (active_perception_env.py:101-121);
      the vector template keeps them and only overlays the AP keys
      (active_perception_vector_env.py:84-111).
    """
    prediction = full_action["prediction"]
    obs, base_reward, terminated, truncated, step_info, target = env._step(
        full_action["action"], prediction
    )
    loss = env.loss_fn(prediction, target, batch_shape)
    ap_info = {
        "base_reward": base_reward,
        "prediction": {"target": target, "loss": loss},
    }
    info = {**step_info, **ap_info} if merge_info else ap_info
    return obs, base_reward - loss, terminated, truncated, info


# ---------------------------------------------------------------------------
# Single-env classes (behavioral spec: active_perception_env.py)


class BaseActivePerceptionEnv(gym.Env, ABC):
    """gym.Env + loss_fn/prediction spaces (active_perception_env.py:71-88).
    Subclasses set ``action_space`` (an ActivePerceptionActionSpace),
    ``prediction_target_space`` and ``loss_fn``."""

    prediction_target_space: gym.Space
    loss_fn: Any

    prediction_space = _subspace("action_space", "prediction")
    inner_action_space = _subspace("action_space", "action")


class ActivePerceptionEnv(BaseActivePerceptionEnv, ABC):
    """Single-env step template: reward = base_reward - loss, info REBUILT
    as {"base_reward", "prediction": {"target", "loss"}}
    (active_perception_env.py:90-121)."""

    @abstractmethod
    def _step(self, action, prediction):
        """-> (obs, base_reward, terminated, truncated, info, pred_target)"""

    def step(self, action):
        return _compose_step(self, action, batch_shape=(), merge_info=False)


class ActivePerceptionWrapper(gym.Wrapper, BaseActivePerceptionEnv):
    """Re-exposes loss_fn / prediction_target_space, overridable via the
    ``_loss_fn`` / ``_prediction_target_space`` slots
    (active_perception_env.py:124-166)."""

    loss_fn = _fallthrough("loss_fn")
    prediction_target_space = _fallthrough("prediction_target_space")

    def __init__(self, env):
        self._loss_fn = None
        self._prediction_target_space = None
        super().__init__(ensure_active_perception_env(env))


def _unwrap_chain(env, wrapper_types):
    """Iterate an env and every env below it in its wrapper stack."""
    while True:
        yield env
        if not isinstance(env, wrapper_types):
            return
        env = env.env


def find_loss_and_pred_space(env):
    """Walk a (possibly foreign) gym wrapper stack down to the first layer
    exposing the AP surface (active_perception_env.py:169-180)."""
    for layer in _unwrap_chain(env, gym.Wrapper):
        if _is_ap(layer):
            return layer.loss_fn, layer.prediction_target_space
    raise NoActivePerceptionEnvError(
        "The environment does not contain an ActivePerceptionEnv"
    )


class ActivePerceptionRestoreWrapper(
    _DelegateToInner, gym.Wrapper, BaseActivePerceptionEnv
):
    """Re-surfaces loss_fn/pred space found deeper in a foreign wrapper
    stack (active_perception_env.py:183-210). The reference's own
    ``action_space`` property is broken (reads a never-assigned private
    attr, :199-200) and effectively resolves to the inner env through its
    ``__getattr__``; here gym.Wrapper's default space passthrough gives the
    same resolution without the dead property."""

    loss_fn = _pinned()
    prediction_target_space = _pinned()

    def __init__(self, env):
        super().__init__(env)
        loss_fn, target_space = find_loss_and_pred_space(env)
        _pin(self, loss_fn=loss_fn, prediction_target_space=target_space)


class _PseudoPredictionChannel:
    """Shared plumbing for the pseudo wrappers: grafts a trivial
    (empty-Tuple, zero-loss) prediction channel onto a plain gymnasium env
    and injects the AP info keys (active_perception_env.py:213-248,
    active_perception_vector_env.py:173-212)."""

    def _graft_prediction_channel(self, loss_shape: tuple) -> None:
        self._zero_loss_shape = loss_shape
        self.prediction_target_space = gym.spaces.Tuple(())
        self.loss_fn = zero_loss_fn()

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        info["prediction"] = {"target": ()}
        return obs, info

    def _pseudo_step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action["action"])
        info.update(
            base_reward=reward,
            prediction={
                "target": (),
                "loss": np.zeros(self._zero_loss_shape, dtype=np.float32),
            },
        )
        return obs, reward, terminated, truncated, info


class PseudoActivePerceptionWrapper(
    _PseudoPredictionChannel, gym.Wrapper, BaseActivePerceptionEnv
):
    """Converts a plain gym env: ZeroLossFn, empty Tuple prediction spaces,
    base_reward/prediction info injection (active_perception_env.py:213-248)."""

    def __init__(self, env):
        gym.Wrapper.__init__(self, env)
        self.action_space = ActivePerceptionActionSpace(
            self.env.action_space, gym.spaces.Tuple(())
        )
        self._graft_prediction_channel(())

    def step(self, action):
        obs, reward, terminated, truncated, info = self._pseudo_step(action)
        return obs, float(reward), terminated, truncated, info


def _ensure(env, native_check, restore_cls, pseudo_cls):
    """The reference's three-way dispatch: passthrough -> Restore (digs
    foreign wrapper stacks) -> Pseudo (plain gym env)
    (active_perception_env.py:251-258, ..._vector_env.py:311-320)."""
    if native_check(env):
        return env
    try:
        return restore_cls(env)
    except NoActivePerceptionEnvError:
        return pseudo_cls(env)


def ensure_active_perception_env(env):
    return _ensure(
        env, _is_ap, ActivePerceptionRestoreWrapper, PseudoActivePerceptionWrapper
    )


# ---------------------------------------------------------------------------
# Vector classes (behavioral spec: active_perception_vector_env.py)


class BaseActivePerceptionVectorEnv(gym.vector.VectorEnv, ABC):
    prediction_target_space: gym.Space
    single_prediction_target_space: gym.Space
    loss_fn: Any

    prediction_space = _subspace("action_space", "prediction")
    inner_action_space = _subspace("action_space", "action")
    single_prediction_space = _subspace("single_action_space", "prediction")
    single_inner_action_space = _subspace("single_action_space", "action")


class ActivePerceptionVectorEnv(BaseActivePerceptionVectorEnv, ABC):
    """Vector step template: same reward composition but the env's own info
    keys survive (active_perception_vector_env.py:84-111; the single-env
    template replaces instead — an observable asymmetry, see _compose_step)."""

    @abstractmethod
    def _step(self, action, prediction):
        """-> (obs, base_reward, terminated, truncated, info, pred_target)"""

    def step(self, action):
        return _compose_step(
            self, action, batch_shape=(self.num_envs,), merge_info=True
        )


class ActivePerceptionVectorWrapper(
    gym.vector.VectorWrapper, BaseActivePerceptionVectorEnv
):
    loss_fn = _fallthrough("loss_fn")
    prediction_target_space = _fallthrough("prediction_target_space")
    single_prediction_target_space = _fallthrough("single_prediction_target_space")

    def __init__(self, env):
        self._loss_fn = None
        self._prediction_target_space = None
        self._single_prediction_target_space = None
        super().__init__(ensure_active_perception_vector_env(env))


@contextmanager
def _borrow_sub_env(env):
    """Yield a representative single sub-env of a gymnasium vector env, or
    None if this layer has no inspectable sub-envs. SyncVectorEnv lends
    envs[0]; AsyncVectorEnv sub-envs live in worker processes, so a
    throwaway env is built from env_fns[0] and closed again
    (reference behavior, active_perception_vector_env.py:231-247)."""
    if isinstance(env, gym.vector.SyncVectorEnv):
        yield env.envs[0]
    elif isinstance(env, gym.vector.AsyncVectorEnv):
        sub = env.env_fns[0]()
        try:
            yield sub
        finally:
            sub.close()
    else:
        yield None


def find_loss_and_pred_space_vec(env):
    """Vector variant of the AP-surface search: walks VectorWrapper stacks
    and, on reaching a Sync/AsyncVectorEnv of single envs, continues the
    search in a borrowed sub-env and batches the resulting target space
    (active_perception_vector_env.py:215-251)."""
    for layer in _unwrap_chain(env, gym.vector.VectorWrapper):
        if _is_vec_ap(layer):
            return (
                layer.loss_fn,
                layer.single_prediction_target_space,
                layer.prediction_target_space,
            )
        with _borrow_sub_env(layer) as sub:
            if sub is not None:
                loss_fn, single = find_loss_and_pred_space(sub)
                return (
                    loss_fn,
                    single,
                    gym.vector.utils.batch_space(single, layer.num_envs),
                )
    raise NoActivePerceptionEnvError(
        "The environment does not contain an ActivePerceptionEnv"
    )


class ActivePerceptionVectorRestoreWrapper(
    _DelegateToInner, gym.vector.VectorWrapper, BaseActivePerceptionVectorEnv
):
    """Re-surfaces the AP surface of a foreign vector stack and re-tags the
    batched Dict action spaces as ActivePerceptionActionSpaces
    (active_perception_vector_env.py:254-308)."""

    loss_fn = _pinned()
    action_space = _pinned()
    single_action_space = _pinned()
    prediction_target_space = _pinned()
    single_prediction_target_space = _pinned()

    def __init__(self, env):
        super().__init__(env)
        loss_fn, single_target, target = find_loss_and_pred_space_vec(env)
        _pin(
            self,
            loss_fn=loss_fn,
            prediction_target_space=target,
            single_prediction_target_space=single_target,
            action_space=ActivePerceptionActionSpace.from_dict(env.action_space),
            single_action_space=ActivePerceptionActionSpace.from_dict(
                env.single_action_space
            ),
        )

    def __del__(self):
        # Mirrors the reference's guard against gymnasium's GC bug
        # (active_perception_vector_env.py:305-308).
        pass


class PseudoActivePerceptionVectorWrapper(
    _PseudoPredictionChannel, gym.vector.VectorWrapper, BaseActivePerceptionVectorEnv
):
    """(active_perception_vector_env.py:173-212)."""

    def __init__(self, env):
        gym.vector.VectorWrapper.__init__(self, env)
        self.single_action_space = ActivePerceptionActionSpace(
            self.env.single_action_space, gym.spaces.Tuple(())
        )
        self.action_space = ActivePerceptionActionSpace(
            self.env.action_space, gym.spaces.Tuple(())
        )
        self.single_prediction_target_space = gym.spaces.Tuple(())
        self._graft_prediction_channel((self.num_envs,))

    step = _PseudoPredictionChannel._pseudo_step


def ensure_active_perception_vector_env(env):
    return _ensure(
        env,
        _is_vec_ap,
        ActivePerceptionVectorRestoreWrapper,
        PseudoActivePerceptionVectorWrapper,
    )


# ---------------------------------------------------------------------------
# Task-family bases (active_classification_env.py:28-65,
# active_regression_env.py:29-110)


def _install_ap_contract(
    env, inner_space, prediction_space, target_space, loss_fn, num_envs=None
):
    """Wire the AP attributes of a task-family subclass. With ``num_envs``
    the batched twins are derived through gym's batch_space machinery
    (which the custom registrations in gym_spaces keep subclass-correct)."""
    ap_space = ActivePerceptionActionSpace(inner_space, prediction_space)
    if num_envs is None:
        env.action_space = ap_space
        env.prediction_target_space = target_space
    else:
        env.num_envs = num_envs
        env.single_action_space = ap_space
        env.action_space = gym.vector.utils.batch_space(ap_space, num_envs)
        env.single_prediction_target_space = target_space
        env.prediction_target_space = gym.vector.utils.batch_space(
            target_space, num_envs
        )
    env.loss_fn = loss_fn


def _classification_contract(num_classes):
    """Logit prediction over K classes, Discrete target, normalized
    cross-entropy (active_classification_env.py:28-39)."""
    return (
        LogitSpace(-np.inf, np.inf, shape=(num_classes,)),
        gym.spaces.Discrete(num_classes),
        cross_entropy_loss_fn(num_classes).normalized,
    )


class ActiveClassificationEnv(ActivePerceptionEnv, ABC):
    def __init__(self, num_classes: int, inner_action_space: gym.Space):
        pred, target, loss = _classification_contract(num_classes)
        _install_ap_contract(self, inner_action_space, pred, target, loss)


class ActiveClassificationVectorEnv(ActivePerceptionVectorEnv, ABC):
    def __init__(self, num_envs, num_classes, single_inner_action_space):
        pred, target, loss = _classification_contract(num_classes)
        _install_ap_contract(
            self, single_inner_action_space, pred, target, loss, num_envs=num_envs
        )


def _regression_contract(target_dim, low, high, target_std=None):
    """Box prediction == target space; MSE normalized under the
    (high - low)/sqrt(12) uniform assumption, with the reference's warning
    for unbounded spaces (active_regression_env.py:29-52)."""
    space = gym.spaces.Box(low=low, high=high, shape=(target_dim,))
    if target_std is None and np.all(np.isfinite(space.low)) and np.all(
        np.isfinite(space.high)
    ):
        target_std = (high - low) / np.sqrt(12)
    loss = mse_loss_fn(target_std=target_std)
    if target_std is not None:
        loss = loss.normalized
    else:
        import logging

        logging.getLogger(__name__).warning(
            "Prediction target space is unbounded, and target_std is not "
            "provided. MSE loss will not be normalized."
        )
    return space, space, loss


class ActiveRegressionEnv(ActivePerceptionEnv, ABC):
    def __init__(
        self,
        target_dim: int,
        inner_action_space: gym.Space,
        prediction_low=-1.0,
        prediction_high=1.0,
        target_std=None,
    ):
        pred, target, loss = _regression_contract(
            target_dim, prediction_low, prediction_high, target_std
        )
        _install_ap_contract(self, inner_action_space, pred, target, loss)


class ActiveRegressionVectorEnv(ActivePerceptionVectorEnv, ABC):
    def __init__(
        self,
        num_envs: int,
        target_dim: int,
        single_inner_action_space: gym.Space,
        prediction_low=-1.0,
        prediction_high=1.0,
        target_std=None,
    ):
        pred, target, loss = _regression_contract(
            target_dim, prediction_low, prediction_high, target_std
        )
        _install_ap_contract(
            self, single_inner_action_space, pred, target, loss, num_envs=num_envs
        )


# ---------------------------------------------------------------------------
# TimeLimit (time_limit.py:17-166)


class TimeLimit(gym.Wrapper, gym.utils.RecordConstructorArgs):
    def __init__(
        self,
        env: gym.Env,
        max_episode_steps: int,
        issue_termination: bool = False,
        observe_time_steps: bool | None = None,
    ):
        # Ctor args are recorded so gymnasium can reconstruct the wrapper
        # from a spec (reference time_limit.py:49-54).
        gym.utils.RecordConstructorArgs.__init__(
            self,
            max_episode_steps=max_episode_steps,
            issue_termination=issue_termination,
            observe_time_steps=observe_time_steps,
        )
        gym.Wrapper.__init__(self, env)
        self._max_episode_steps = int(max_episode_steps)
        self._issue_termination = bool(issue_termination)
        self._observe_time_steps = (
            issue_termination if observe_time_steps is None else bool(observe_time_steps)
        )
        self._elapsed_steps = None
        self._cached_spec = None
        if self._observe_time_steps:
            self.observation_space = self._augmented_space(env.observation_space)

    @property
    def spec(self):
        """env.spec with max_episode_steps patched to this wrapper's limit
        (reference time_limit.py:154-166), so tooling that reads
        spec.max_episode_steps sees the effective horizon."""
        if self._cached_spec is not None:
            return self._cached_spec
        import copy

        env_spec = self.env.spec
        if env_spec is not None:
            env_spec = copy.copy(env_spec)
            env_spec.max_episode_steps = self._max_episode_steps
        self._cached_spec = env_spec
        return env_spec

    def _augmented_space(self, space):
        time_space = gym.spaces.Box(low=-1.0, high=1.0, shape=(), dtype=np.float32)
        if isinstance(space, gym.spaces.Dict):
            return gym.spaces.Dict({**space.spaces, "time_step": time_space})
        if isinstance(space, gym.spaces.Tuple):
            return gym.spaces.Tuple((*space.spaces, time_space))
        if isinstance(space, gym.spaces.Box) and np.issubdtype(
            space.dtype, np.floating
        ) and len(space.shape) == 1:
            return gym.spaces.Box(
                low=np.concatenate([space.low, [-1.0]]).astype(space.dtype),
                high=np.concatenate([space.high, [1.0]]).astype(space.dtype),
                dtype=space.dtype,
            )
        return gym.spaces.Dict({"observation": space, "time_step": time_space})

    def _time_obs(self):
        return np.array(
            2.0 * self._elapsed_steps / self._max_episode_steps - 1.0,
            dtype=np.float32,
        )

    def _wrap_obs(self, obs):
        if not self._observe_time_steps:
            return obs
        if isinstance(obs, dict):
            return {**obs, "time_step": self._time_obs()}
        if isinstance(obs, tuple):
            return (*obs, self._time_obs())
        if isinstance(obs, np.ndarray) and obs.ndim == 1:
            return np.concatenate([obs, [self._time_obs().astype(obs.dtype)]])
        return {"observation": obs, "time_step": self._time_obs()}

    def reset(self, *, seed=None, options=None):
        self._elapsed_steps = 0
        obs, info = self.env.reset(seed=seed, options=options)
        return self._wrap_obs(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self._max_episode_steps:
            if self._issue_termination:
                terminated = True
            else:
                truncated = True
        return self._wrap_obs(obs), reward, terminated, truncated, info


# ---------------------------------------------------------------------------
# Sparsify (sparsify_wrapper.py:23-164)


def _weightify(info, terminated):
    info = dict(info)
    pred = dict(info.get("prediction", {}))
    if "target" in pred:
        pred["target"] = {
            "target": pred["target"],
            "weight": np.asarray(terminated, dtype=np.float32),
        }
    info["prediction"] = pred
    return info


class SparsifyWrapper(ActivePerceptionWrapper):
    """Loss counts only on the final step: target becomes
    {"target", "weight"} with weight = terminated, reward recomputed as
    base_reward - weighted loss (sparsify_wrapper.py:109-160). NOTE: the
    reference's reset crashes (KeyError on the missing info["prediction"],
    :153-160); here, as in apx, reset degrades gracefully by only
    weight-wrapping when the key exists."""

    def __init__(self, env):
        super().__init__(env)
        self._prediction_target_space = gym.spaces.Dict(
            {
                "target": self.env.prediction_target_space,
                "weight": gym.spaces.Box(0, 1, shape=(), dtype=np.float32),
            }
        )
        self._loss_fn = weighted_loss_fn(self.env.loss_fn)

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return obs, _weightify(info, 0.0)

    def step(self, action):
        obs, _, terminated, truncated, info = self.env.step(action)
        info = _weightify(info, 1.0 if terminated else 0.0)
        reward = info["base_reward"] - self.loss_fn(
            action["prediction"], info["prediction"]["target"], ()
        )
        return obs, reward, terminated, truncated, info


class SparsifyVectorWrapper(ActivePerceptionVectorWrapper):
    """(sparsify_wrapper.py:23-97)."""

    def __init__(self, env):
        super().__init__(env)
        self._single_prediction_target_space = gym.spaces.Dict(
            {
                "target": self.env.single_prediction_target_space,
                "weight": gym.spaces.Box(0, 1, shape=(), dtype=np.float32),
            }
        )
        self._prediction_target_space = gym.vector.utils.batch_space(
            self._single_prediction_target_space, self.num_envs
        )
        self._loss_fn = weighted_loss_fn(self.env.loss_fn)

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return obs, _weightify(info, np.zeros(self.num_envs, np.float32))

    def step(self, action):
        obs, _, terminated, truncated, info = self.env.step(action)
        info = _weightify(info, np.asarray(terminated, np.float32))
        reward = info["base_reward"] - self.loss_fn(
            action["prediction"], info["prediction"]["target"], (self.num_envs,)
        )
        return obs, reward, terminated, truncated, info


# ---------------------------------------------------------------------------
# VectorToSingle (vector_to_single_wrapper.py:18-129)


def _tree_expand(x):
    if isinstance(x, dict):
        return {k: _tree_expand(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_tree_expand(v) for v in x)
    return np.asarray(x)[None]


def _tree_squeeze(x):
    if isinstance(x, dict):
        return {k: _tree_squeeze(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_tree_squeeze(v) for v in x)
    a = np.asarray(x)
    return a[0] if a.ndim else a


class VectorToSingleWrapper(gym.Env):
    """Runs a 1-env VectorEnv as a single env: x -> x[None] on the way in,
    x -> x[0] on the way out (vector_to_single_wrapper.py:18-103)."""

    def __init__(self, env):
        assert env.num_envs == 1, "VectorToSingleWrapper requires num_envs == 1"
        self.env = env
        self.observation_space = env.single_observation_space
        self.action_space = env.single_action_space
        self.metadata = env.metadata
        self.render_mode = getattr(env, "render_mode", None)
        self.spec = getattr(env, "spec", None)

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return _tree_squeeze(obs), _tree_squeeze(info)

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(_tree_expand(action))
        return (
            _tree_squeeze(obs),
            float(np.asarray(reward)[0]),
            bool(np.asarray(term)[0]),
            bool(np.asarray(trunc)[0]),
            _tree_squeeze(info),
        )

    def render(self):
        out = self.env.render()
        return out[0] if isinstance(out, (list, tuple)) else out

    def close(self):
        self.env.close()

    @property
    def np_random(self):
        return self.env.np_random

    @np_random.setter
    def np_random(self, value):
        self.env.np_random = value


class ActivePerceptionVectorToSingleWrapper(VectorToSingleWrapper):
    """Adds loss_fn / prediction spaces passthrough from the single_*
    variants (vector_to_single_wrapper.py:106-129)."""

    @property
    def loss_fn(self):
        return self.env.loss_fn

    @property
    def prediction_target_space(self):
        return self.env.single_prediction_target_space

    @property
    def prediction_space(self):
        return self.env.single_prediction_space

    @property
    def inner_action_space(self):
        return self.env.single_inner_action_space
