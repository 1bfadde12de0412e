"""Gymnasium drop-in layer of the port (counterpart of apx.compat).

``apx_torch.compat.make(env_id)`` / ``make_vec(env_id, num_envs)`` mirror
``ap_gym.make`` / ``ap_gym.make_vec`` (registration.py:731-767): numpy
in/out, the reference's info contract, log wrappers attached per task
family, ``render()``, and (default) the reference's exact host RNG draw
chains, so a seeded episode is the same numpy arrays ``apx.compat``
returns.

    import apx_torch.compat as apc
    env = apc.make_vec("LIDARLocRooms-v0", num_envs=64)     # on the card
    obs, info = env.reset(seed=0)
    obs, reward, terminated, truncated, info = env.step(
        {"action": np.zeros((64, 2), np.float32),
         "prediction": np.zeros((64, 2), np.float32)})

Entry points run on the card unless the caller passes ``device="cpu"``.
``make`` and ``make_vec`` return gymnasium classes and need gymnasium
(and ``render()`` needs pillow); without gymnasium they raise an
ImportError that names it. The device-facing core needs neither:
``adapter.VectorAdapter`` (reset, step, the wire codec, the tracker) and
``stats`` (the log wrappers' aggregation), which ``make_core`` builds.

The reference's class layer is here too (``gym_classes``, ``gym_spaces``,
``dataset_classes``, ``perception_module``, and ``ap_gym_alias``, which
makes ``import ap_gym`` resolve to it); ``ensure_active_perception_env``
and ``ensure_active_perception_vector_env`` are re-exported as apx.compat
re-exports them, imported on first use so that ``import apx_torch.compat``
needs no gymnasium.
"""

from __future__ import annotations

from ..core.env import AutoResetMode
from ..registry import _device, _entry
from .adapter import VectorAdapter
from .loss_adapter import CompatLossFn
from .spaces import to_gym_space

__all__ = [
    "make",
    "make_vec",
    "make_core",
    "VectorAdapter",
    "CompatLossFn",
    "to_gym_space",
    "ensure_active_perception_env",
    "ensure_active_perception_vector_env",
]

_CLASS_LAYER = ("ensure_active_perception_env", "ensure_active_perception_vector_env")


def __getattr__(name: str):
    # Full reference dispatch (passthrough -> RestoreWrapper -> PseudoWrapper,
    # active_perception_env.py:251-258), from the gymnasium class layer.
    if name in _CLASS_LAYER:
        from . import gym_classes

        return getattr(gym_classes, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _gym_shells():
    try:
        from . import gym_env, log
    except ImportError as exc:
        raise ImportError(
            "apx_torch.compat.make / make_vec return gymnasium environments and need the "
            "'gymnasium' package; the gymnasium-free core is "
            "apx_torch.compat.make_core (VectorAdapter)"
        ) from exc
    return gym_env, log


def _mk_spec(env_id: str, entry):
    """EnvSpec with the effective episode horizon. The reference reports
    step_limit through spec for every family — image envs via a spec setter
    (image_classification.py:151-159), LIDAR/LightDark via TimeLimit's spec
    patching (time_limit.py:154-166)."""
    from gymnasium.envs.registration import EnvSpec

    return EnvSpec(
        id=env_id,
        entry_point="apx_torch.compat:make",
        max_episode_steps=entry.step_limit,
    )


def _build(env_id: str, device, overrides):
    if overrides.pop("render_mode", "rgb_array") != "rgb_array":
        raise ValueError("only render_mode='rgb_array' is supported")
    entry = _entry(env_id)
    env = entry.build(_device(device))
    return entry, env, env.default_params(**overrides)


def _autoreset(entry, vector: bool) -> str:
    # Image-env families autoreset in lockstep inside step() (the
    # reference's native vector envs); LightDark/LIDAR are plain envs as
    # singles and NEXT_STEP under vectorization (SURVEY §3.5).
    if entry.autoreset is AutoResetMode.LOCKSTEP:
        return "lockstep"
    return "next_step" if vector else "none"


def make_core(
    env_id: str,
    num_envs: int = 1,
    rng: str = "reference",
    key_impl: str | None = None,
    device="cuda",
    **overrides,
) -> VectorAdapter:
    """The gymnasium-free vector adapter ``make_vec`` wraps (no log
    wrapper, no vector-level wrapper such as HideAndSeek's)."""
    entry, env, params = _build(env_id, device, overrides)
    if entry.vector_wrapper is not None:
        raise ValueError(f"{env_id} has a vector-level wrapper; use make_vec")
    return VectorAdapter(env, params, num_envs, autoreset=_autoreset(entry, True), rng=rng,
                         sparse=entry.sparse, key_impl=key_impl)


def make(
    env_id: str,
    rng: str = "reference",
    log_wrapper: bool = True,
    key_impl: str | None = None,
    device="cuda",
    **overrides,
):
    """The single env (gymnasium ``Env``), with the id's log wrapper.
    Arguments as apx.compat.make's, and ``device``."""
    gym_env, log = _gym_shells()
    if _entry(env_id).vector_wrapper is not None:
        # Hide-and-seek: single env = squeezed 1-env vector pipeline, like
        # the reference (registration.py:482-489).
        vec = make_vec(env_id, num_envs=1, device=device, rng=rng, log_wrapper=False,
                       key_impl=key_impl, **overrides)
        entry = _entry(env_id)
        env = gym_env.GymAPEnv(vec=vec)
    else:
        entry, base, params = _build(env_id, device, overrides)
        env = gym_env.GymAPEnv(base, params, autoreset=_autoreset(entry, False), rng=rng,
                               sparse=entry.sparse, key_impl=key_impl)
    env.spec = _mk_spec(env_id, entry)
    if log_wrapper and entry.metrics == "classification":
        env = log.ClassificationLogWrapper(env)
    elif log_wrapper and entry.metrics == "regression":
        env = log.RegressionLogWrapper(env)
    return env


def make_vec(
    env_id: str,
    num_envs: int = 1,
    rng: str = "reference",
    log_wrapper: bool = True,
    key_impl: str | None = None,
    device="cuda",
    **overrides,
):
    """The vector env (gymnasium ``VectorEnv``), with the id's vector log
    wrapper. Arguments as apx.compat.make_vec's, and ``device``."""
    gym_env, log = _gym_shells()
    entry, base, params = _build(env_id, device, overrides)
    env = gym_env.GymVectorAPEnv(
        base, params, num_envs=num_envs, autoreset=_autoreset(entry, True),
        rng=rng,  # next_step families use per-sub-env np_random chains
        # matching the reference's SyncVectorEnv (seed+i per sub-env).
        sparse=entry.sparse, key_impl=key_impl,
    )
    if entry.vector_wrapper is not None:
        from .hide_and_seek import GymHideAndSeekWrapper

        env = GymHideAndSeekWrapper(
            env, mask_prediction=entry.vector_wrapper(None).mask_prediction)
    env.spec = _mk_spec(env_id, entry)
    if log_wrapper and entry.metrics == "classification":
        env = log.VectorClassificationLogWrapper(env)
    elif log_wrapper and entry.metrics == "regression":
        env = log.VectorRegressionLogWrapper(env)
    return env
