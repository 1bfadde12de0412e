"""Batched active-perception environment API (counterpart of apx.core.env).

apx writes each env for ONE instance and lifts it with ``jax.vmap``; here
every env function takes and returns tensors with a leading env axis N:

    obs, state, info = env.reset_env(num_envs, params, generator)
    r = env.step_env(state, action, prediction, params, draws)   # APStepResult

Randomness is split into draws from an explicit ``torch.Generator`` and
deterministic functions of them, so a test can inject the exact draws the
JAX reference made from its threefry keys: ``draw_reset`` feeds
``reset_from_draws``, and ``draw_step`` feeds ``step_env`` (apx hands such
envs a step key, ``step_uses_rng``; envs whose step draws nothing return
``{}`` and consume nothing). A vector step draws its step draws before its
reset draws, in the order of apx's split ``(step_key, reset_key)``.

``VectorAPEnv`` adds the reward composition (``base_reward - loss``, as
``LossFn.reward`` rounds it) and
mask autoreset. NEXT_STEP and LOCKSTEP always run the reset for all envs
(NEXT_STEP names the envs that were done, ``autoreset_from_draws``'s
``only``, and an env may compute those alone: LIDAR's kernel R does)
and merge it under the reset mask: apx gates the same merge behind
``lax.cond`` and pins the two forms bitwise-equal (apx/core/env.py:228-238,
:366-376), and the masked form never asks the host whether any env is
done, so a step never synchronises with the device and can be captured in
a CUDA graph. LOCKSTEP's mask is ``prev_done.all()``, decided on the
device. ``rollout_episodic`` hoists the LOCKSTEP boundary out of the step:
``period`` DISABLED steps, then one ``boundary_reset_step``.

NEXT_STEP's merge, loss, reward and ``TimeLimit`` counter are
``ops.merge_cuda.next_step`` (``VectorAPEnv._next_step``): F2, one kernel,
on the card for an MSE loss (``MSELossFn``, or an ``AffineLossFn`` over
one, of the widths ``core.losses.mse_terms`` accepts: LIDAR, LightDark);
its plain form ``ops.merge`` on the CPU and, on the card, for every
other loss (the ``-sparse`` ids' weighted loss, cross-entropy, zero), with
N1-N3 at its rounding sites. LOCKSTEP and DISABLED keep the op-by-op
merge of ``step``, but for the loss and the reward, which they and
``boundary_reset_step`` compute with ``ops.loss_cuda.loss_and_reward``: P,
one kernel, on the card for a cross-entropy or MSE loss, the plain chain
``loss_fn(...)``, ``loss_fn.reward(...)`` on the CPU and for other losses.

The vector env's stages are spans (``core.trace``): ``vector.step``,
``vector.boundary_reset`` and ``vector.reset`` around its entries, and
inside them ``env.step`` around each ``step_env``, ``env.reset`` around
each reset from draws (and the reset's prediction target on a boundary)
and ``env.draw`` around the draws it makes itself. A vector span's own
time is the merge: the selects, the loss, the reward, the derived obs and
``compose_info``. Where the loss and the reward are computed outside F2
(LOCKSTEP, DISABLED and the boundary step), ``vector.loss`` is open around
``loss_and_reward``; F2's call under NEXT_STEP is not wrapped, since there
the loss is inside the one kernel.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Generic, TypeVar

import torch

from ..ops import loss_cuda
from .losses import LossFn
from .spaces import ActivePerceptionActionSpace, Space
from .trace import span

__all__ = [
    "APEnv",
    "APStepResult",
    "AutoResetMode",
    "VectorAPEnv",
    "VectorState",
    "vector_env",
    "rollout",
    "rollout_episodic",
    "tree_map",
    "tree_select",
    "with_autoreset",
]

P = TypeVar("P")
S = TypeVar("S")


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts, tuples, lists and
    dataclasses (the port's stand-in for ``jax.tree_util.tree_map``).
    ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def tree_select(mask: torch.Tensor, a, b):
    """Leafwise ``where(mask, a, b)`` with ``mask`` (N,) broadcast over
    each leaf's trailing axes."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return torch.where(m, x, y)

    return tree_map(sel, a, b)


@dataclasses.dataclass
class APStepResult:
    """Raw batched result of an env's ``step_env`` before loss composition."""

    obs: Any
    state: Any
    base_reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: dict[str, Any]
    prediction_target: Any

    def replace(self, **changes) -> "APStepResult":
        return dataclasses.replace(self, **changes)


class AutoResetMode(enum.Enum):
    NEXT_STEP = "next_step"
    LOCKSTEP = "lockstep"
    DISABLED = "disabled"


class APEnv(Generic[P, S]):
    """Batched functional active-perception environment."""

    # ---- static metadata -------------------------------------------------
    def default_params(self, **overrides) -> P:
        raise NotImplementedError

    def observation_space(self, params: P) -> Space:
        raise NotImplementedError

    def inner_action_space(self, params: P) -> Space:
        raise NotImplementedError

    def prediction_space(self, params: P) -> Space:
        raise NotImplementedError

    def prediction_target_space(self, params: P) -> Space:
        raise NotImplementedError

    def action_space(self, params: P) -> ActivePerceptionActionSpace:
        return ActivePerceptionActionSpace.create(
            self.inner_action_space(params), self.prediction_space(params)
        )

    def loss_fn(self, params: P) -> LossFn:
        raise NotImplementedError

    # ---- dynamics --------------------------------------------------------
    def draw_reset(
        self, num_envs: int, params: P, generator: torch.Generator
    ) -> dict[str, torch.Tensor]:
        """The random numbers one batched reset consumes."""
        raise NotImplementedError

    def reset_from_draws(self, draws: dict[str, torch.Tensor], params: P):
        """Deterministic batched reset: returns (obs, state, info)."""
        raise NotImplementedError

    def autoreset_from_draws(self, draws, old_state: S, params: P, only=None):
        """Reset used on an autoreset step; defaults to reset_from_draws.
        ``only`` (N,) bool, or None for every env: the envs whose reset the
        caller reads. An env may leave the others' leaves unspecified; the
        default resets every env."""
        return self.reset_from_draws(draws, params)

    def reset_env(self, num_envs: int, params: P, generator: torch.Generator):
        return self.reset_from_draws(self.draw_reset(num_envs, params, generator), params)

    def draw_step(
        self, num_envs: int, params: P, generator: torch.Generator | None
    ) -> dict[str, torch.Tensor]:
        """The random numbers one batched step consumes: none by default
        (and nothing is taken from the generator)."""
        return {}

    def step_env(self, state: S, action, prediction, params: P, draws=None) -> APStepResult:
        """One batched step from ``draw_step``'s ``draws`` (ignored by envs
        whose step draws nothing)."""
        raise NotImplementedError

    def prediction_target_on_reset(self, old_state: S, new_state: S, params: P):
        raise NotImplementedError

    def obs_derived_from_state(self, state: S, params: P) -> dict[str, Any]:
        """Observation entries that are elementwise functions of the
        post-step state (LIDAR's map channel). They are computed once from
        the merged state by the vector layer (apx.core.env, same name)."""
        return {}

    def obs_derived_spec(self, params: P) -> dict[str, tuple[str, float]] | None:
        """``obs_derived_from_state`` as the fused merge computes it in its
        kernel: obs key -> (bool state field, divisor), the entry being
        ``state.<field>[..., None]`` as float32 divided by the divisor
        (``ops.merge``); None (the default): the merge calls
        ``obs_derived_from_state`` on the merged state instead."""
        return None

    def split_counter(self, state: S) -> tuple["APEnv", Any, Any]:
        """(the env whose step and reset the NEXT_STEP merge runs, its
        state, the step counter the merge keeps for it or None):
        ``(self, state, None)``; a ``TimeLimit`` gives its inner env and
        its ``Counter``, and ``join_counter`` wraps the merged result."""
        return self, state, None

    def join_counter(self, obs, state, t, time_obs):
        """(obs, state) of this env from the merged inner ones and the
        merged counter (see ``split_counter``): ``(obs, state)``."""
        return obs, state

    def _merge_derived_obs(self, obs, state: S, params: P):
        d = self.obs_derived_from_state(state, params)
        return {**obs, **d} if d else obs

    def compose_info(self, info, base_reward, pred_target, loss, prediction, params: P):
        return {
            **info,
            "base_reward": base_reward,
            "prediction": {"target": pred_target, "loss": loss},
        }

    # ---- template methods --------------------------------------------------
    def reset(self, num_envs: int, params: P, generator: torch.Generator):
        obs, state, info = self.reset_env(num_envs, params, generator)
        return self._merge_derived_obs(obs, state, params), state, info

    def step(self, state: S, full_action: dict[str, Any], params: P,
             generator: torch.Generator | None = None, draws=None):
        """Composite step: reward = base_reward - loss_fn(prediction, target).
        The step draws come from ``generator`` unless injected."""
        if draws is None:
            draws = self.draw_step(num_envs_of(state), params, generator)
        r = self.step_env(state, full_action["action"], full_action["prediction"], params, draws)
        loss_fn = self.loss_fn(params)
        loss = loss_fn(full_action["prediction"], r.prediction_target)
        reward = loss_fn.reward(r.base_reward, loss, full_action["prediction"],
                                r.prediction_target)
        info = self.compose_info(
            r.info, r.base_reward, r.prediction_target, loss,
            full_action["prediction"], params,
        )
        obs = self._merge_derived_obs(r.obs, r.state, params)
        return obs, r.state, reward, r.terminated, r.truncated, info


@dataclasses.dataclass
class VectorState:
    inner: Any
    prev_done: torch.Tensor  # (N,) bool


@dataclasses.dataclass(frozen=True)
class VectorAPEnv:
    """Vector env with mask autoreset (NEXT_STEP, LOCKSTEP or DISABLED)."""

    env: APEnv
    num_envs: int
    autoreset: AutoResetMode = AutoResetMode.NEXT_STEP

    @span("vector.reset")
    def reset(self, params, generator: torch.Generator | None = None, draws=None):
        """Batched reset from ``generator``, or from injected ``draws``."""
        if draws is None:
            with span("env.draw"):
                draws = self.env.draw_reset(self.num_envs, params, _need(generator))
        with span("env.reset"):
            obs, state, info = self.env.reset_from_draws(draws, params)
        obs = self.env._merge_derived_obs(obs, state, params)
        prev_done = torch.zeros(self.num_envs, dtype=torch.bool, device=state_device(state))
        return obs, VectorState(inner=state, prev_done=prev_done), info

    @span("vector.step")
    def step(self, state: VectorState, full_action: dict[str, Any], params,
             generator: torch.Generator | None = None, reset_draws=None, step_draws=None):
        """One vector step. NEXT_STEP resets the envs that were done at the
        previous step, LOCKSTEP all envs once every env is done, from
        ``generator`` or from injected ``reset_draws`` (draws for all N
        envs; only the reset envs' are used). The step's own draws come
        from ``generator`` first, unless injected as ``step_draws``. On a
        LOCKSTEP reset step the base reward is 0, the dones are False and
        the loss is taken against the new episode's target
        (``APEnv.prediction_target_on_reset``)."""
        env = self.env
        loss_fn = env.loss_fn(params)
        if self.autoreset is AutoResetMode.NEXT_STEP:
            return self._next_step(state, full_action, params, loss_fn, generator, reset_draws,
                                   step_draws)
        if step_draws is None:
            with span("env.draw"):
                step_draws = env.draw_step(self.num_envs, params, generator)
        with span("env.step"):
            r = env.step_env(
                state.inner, full_action["action"], full_action["prediction"], params, step_draws
            )

        if self.autoreset is AutoResetMode.DISABLED:
            with span("vector.loss"):
                loss, reward = loss_cuda.loss_and_reward(loss_fn, r.base_reward,
                                                         full_action["prediction"],
                                                         r.prediction_target)
            info = env.compose_info(
                r.info, r.base_reward, r.prediction_target, loss,
                full_action["prediction"], params,
            )
            obs = env._merge_derived_obs(r.obs, r.state, params)
            vstate = VectorState(inner=r.state, prev_done=r.terminated | r.truncated)
            return obs, vstate, reward, r.terminated, r.truncated, info

        # LOCKSTEP decides "all envs done" as a device tensor: no host sync.
        mask = state.prev_done.all().expand(self.num_envs)
        reset_obs, reset_state, reset_info = self._autoreset(env, state.inner, params, generator,
                                                             reset_draws, r.info)
        obs = tree_select(mask, reset_obs, r.obs)
        new_inner = tree_select(mask, reset_state, r.state)
        base_reward = torch.where(mask, 0.0, r.base_reward)
        terminated = mask.logical_not() & r.terminated
        truncated = mask.logical_not() & r.truncated
        info = tree_select(mask, reset_info, r.info)
        # Derived entries once, from the merged state (apx/core/env.py:378-380).
        obs = env._merge_derived_obs(obs, new_inner, params)
        with span("env.reset"):
            reset_target = env.prediction_target_on_reset(state.inner, reset_state, params)
        pred_target = tree_select(mask, reset_target, r.prediction_target)
        with span("vector.loss"):
            loss, reward = loss_cuda.loss_and_reward(loss_fn, base_reward,
                                                     full_action["prediction"], pred_target)
        info = env.compose_info(
            info, base_reward, pred_target, loss, full_action["prediction"], params
        )
        vstate = VectorState(inner=new_inner, prev_done=terminated | truncated)
        return obs, vstate, reward, terminated, truncated, info

    def _autoreset(self, env: APEnv, inner, params, generator, reset_draws, step_info,
                   only=None):
        """The reset that the merge selects from: of every env, the draws
        for all N consumed alike, computed where ``only`` (N,) bool is set
        or everywhere (None)."""
        if reset_draws is None:
            with span("env.draw"):
                reset_draws = self.env.draw_reset(self.num_envs, params, _need(generator))
        with span("env.reset"):
            reset_obs, reset_state, reset_info = env.autoreset_from_draws(reset_draws, inner,
                                                                          params, only=only)
        if set(reset_info) != set(step_info):
            raise ValueError(
                "autoreset info keys differ from step info keys: "
                f"{sorted(reset_info)} vs {sorted(step_info)}"
            )
        return reset_obs, reset_state, reset_info

    def _next_step(self, state: VectorState, full_action, params, loss_fn, generator,
                   reset_draws, step_draws):
        """``step`` under NEXT_STEP: the step and the reset of the env
        under a ``TimeLimit`` (``APEnv.split_counter``), then
        ``ops.merge_cuda.next_step`` merges them, masks the base reward and
        the dones, computes the loss, the reward and the derived obs, and
        keeps the ``TimeLimit``'s counter (see the module docstring)."""
        from ..ops import merge_cuda

        env = self.env
        inner_env, inner, counter = env.split_counter(state.inner)
        prediction = full_action["prediction"]
        if step_draws is None:
            with span("env.draw"):
                step_draws = env.draw_step(self.num_envs, params, generator)
        with span("env.step"):
            r = inner_env.step_env(inner, full_action["action"], prediction, params, step_draws)
        # The merge reads the reset only where the env was done.
        reset = self._autoreset(inner_env, inner, params, generator, reset_draws, r.info,
                                only=state.prev_done)
        m = merge_cuda.next_step(
            state.prev_done, (r.obs, r.state, r.info), reset, r.base_reward, r.terminated,
            r.truncated, prediction, r.prediction_target, loss_fn,
            inner_env.obs_derived_spec(params), counter)
        obs, new_inner = env.join_counter(m.obs, m.state, m.t, m.time_obs)
        if m.derived is None:
            obs = inner_env._merge_derived_obs(obs, m.state, params)
        elif m.derived:
            obs = {**obs, **m.derived}
        info = env.compose_info(m.info, m.base_reward, r.prediction_target, m.loss, prediction,
                                params)
        return (obs, VectorState(inner=new_inner, prev_done=m.done), m.reward, m.terminated,
                m.truncated, info)

    @span("vector.boundary_reset")
    def boundary_reset_step(self, state: VectorState, full_action: dict[str, Any], params,
                            generator: torch.Generator | None = None, reset_draws=None,
                            step_draws=None):
        """The LOCKSTEP all-done reset step on its own: the outputs of
        ``step`` entered with ``prev_done`` all True, without the step whose
        results that step masks out (apx/core/env.py:396-426). It takes
        from ``generator`` what ``step`` takes, and ``step_draws`` are
        unused, as apx's boundary step drops its step key."""
        env = self.env
        if reset_draws is None:
            with span("env.draw"):
                if step_draws is None:
                    env.draw_step(self.num_envs, params, generator)
                reset_draws = env.draw_reset(self.num_envs, params, _need(generator))
        with span("env.reset"):
            reset_obs, reset_state, reset_info = env.autoreset_from_draws(
                reset_draws, state.inner, params
            )
            target = env.prediction_target_on_reset(state.inner, reset_state, params)
        prediction = full_action["prediction"]
        loss_fn = env.loss_fn(params)
        dev = state.prev_done.device
        base_reward = torch.zeros(self.num_envs, dtype=torch.float32, device=dev)
        with span("vector.loss"):
            loss, reward = loss_cuda.loss_and_reward(loss_fn, base_reward, prediction, target)
        done = torch.zeros(self.num_envs, dtype=torch.bool, device=dev)
        info = env.compose_info(reset_info, base_reward, target, loss, prediction, params)
        obs = env._merge_derived_obs(reset_obs, reset_state, params)
        return (obs, VectorState(inner=reset_state, prev_done=done), reward, done,
                torch.zeros_like(done), info)


def _need(generator):
    if generator is None:
        raise ValueError("pass a torch.Generator, or inject the draws")
    return generator


def _first_leaf(tree) -> torch.Tensor:
    found = []
    tree_map(found.append, tree)
    return found[0]


def state_device(state) -> torch.device:
    """Device of the first tensor leaf of a state tree."""
    return _first_leaf(state).device


def num_envs_of(state) -> int:
    """Leading (env) axis of the first tensor leaf of a state tree."""
    return _first_leaf(state).shape[0]


def vector_env(
    env: APEnv, num_envs: int, autoreset: AutoResetMode = AutoResetMode.NEXT_STEP
) -> VectorAPEnv:
    """Counterpart of apx's ``vmap_vector_env``: the env is batched already."""
    return VectorAPEnv(env=env, num_envs=num_envs, autoreset=autoreset)


def rollout(
    venv: VectorAPEnv,
    params,
    policy_fn: Callable[[torch.Generator, Any], dict[str, Any]],
    generator: torch.Generator,
    num_steps: int,
):
    """Python-loop rollout: policy_fn(generator, obs) -> full_action.
    Returns (obs_f, state_f, (rewards, terminated, truncated)) with the
    per-step outputs stacked on a leading time axis."""
    obs, state, _ = venv.reset(params, generator)
    rewards, terms, truncs = [], [], []
    for _ in range(num_steps):
        act = policy_fn(generator, obs)
        obs, state, reward, term, trunc, _ = venv.step(state, act, params, generator)
        rewards.append(reward)
        terms.append(term)
        truncs.append(trunc)
    return obs, state, (torch.stack(rewards), torch.stack(terms), torch.stack(truncs))


def with_autoreset(venv, mode: AutoResetMode):
    """``dataclasses.replace(venv, autoreset=mode)``, recursing through
    vector-level wrappers (the metrics wrappers) that hold the vector env in
    a ``venv`` field and delegate ``autoreset`` (apx/core/env.py:530-545)."""
    if any(f.name == "autoreset" for f in dataclasses.fields(venv)):
        return dataclasses.replace(venv, autoreset=mode)
    if hasattr(venv, "venv"):
        return dataclasses.replace(venv, venv=with_autoreset(venv.venv, mode))
    raise TypeError(
        f"cannot set autoreset on {type(venv).__name__}: no autoreset "
        "field and no inner 'venv' to recurse into"
    )


def rollout_episodic(
    venv: VectorAPEnv,
    params,
    policy_fn: Callable[[torch.Generator, Any], dict[str, Any]],
    generator: torch.Generator,
    num_steps: int,
    period: int,
):
    """LOCKSTEP rollout with the episode boundary hoisted out of the step
    (apx/core/env.py:548-609): ``period`` DISABLED steps, then one
    ``boundary_reset_step``, repeated; a trailing partial cycle runs without
    its boundary. Valid when every episode lasts exactly ``period`` steps,
    as in every image env. Each step draws the step and reset draws
    ``venv.step`` would draw, so the generator advances as in ``rollout``
    and the trajectory is bitwise ``rollout``'s. ``venv`` may be wrapped by
    a vector-level wrapper (``with_autoreset``). Returns what ``rollout``
    returns."""
    if venv.autoreset is not AutoResetMode.LOCKSTEP:
        raise ValueError("rollout_episodic needs a LOCKSTEP vector env")
    inner = with_autoreset(venv, AutoResetMode.DISABLED)
    env, n = venv.env, venv.num_envs
    obs, state, _ = venv.reset(params, generator)
    rewards, terms, truncs = [], [], []
    for i in range(num_steps):
        act = policy_fn(generator, obs)
        step_draws = env.draw_step(n, params, generator)
        draws = env.draw_reset(n, params, generator)
        if i % (period + 1) == period:
            obs, state, reward, term, trunc, _ = venv.boundary_reset_step(
                state, act, params, reset_draws=draws, step_draws=step_draws)
        else:
            obs, state, reward, term, trunc, _ = inner.step(
                state, act, params, step_draws=step_draws)
        rewards.append(reward)
        terms.append(term)
        truncs.append(trunc)
    return obs, state, (torch.stack(rewards), torch.stack(terms), torch.stack(truncs))
