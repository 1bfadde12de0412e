"""The gymnasium-free core of the drop-in adapter (counterpart of the logic
of apx.compat.gym_env's ``GymVectorAPEnv``).

``VectorAdapter`` runs one of the port's batched envs behind the
reference's vector API: numpy in and out, the reference's info contract,
the reward composed on the host with ``loss_fn.numpy`` as the reference's
step template composes it, and, in ``rng="reference"`` mode, the
reference's NumPy PCG64 draw chains (``shims.py``), so that a seeded
episode is the same numpy arrays ``apx.compat`` returns. It needs neither
gymnasium nor PIL: the gymnasium classes (``gym_env.py``) are thin shells
over it, and ``chip_smoke.py`` drives it on the card.

Autoreset modes, as apx's adapter:
  * ``"lockstep"`` (the image families): once every env is done, the next
    step is a reset step (base reward 0, not done, the loss against the
    env's reset target);
  * ``"next_step"`` (LightDark, LIDAR under vectorization): the envs done
    at the previous step reset inside this step; the reset runs for all N
    envs and is merged under the mask, as apx's ``_jit_reset_draws`` and
    ``jit_merge`` run it. In reference mode sub-env i draws from its own
    generator, seeded ``seed + i`` (gymnasium's SyncVectorEnv);
  * ``"none"``: no autoreset (the single-env LIDAR and LightDark).

Each reset and step makes ONE device-to-host transfer, as apx's single
``device_get``: every host-visible tensor (the wire-encoded obs, the base
reward, the dones, the info, the loss target and env 0's render-tracker
slices) is copied ``non_blocking`` into a pinned staging buffer, then the
stream is synchronised once and the values are copied out into numpy
arrays the caller owns (held step outputs pin no memory). The numpy
outputs carry apx's dtypes leaf by leaf: apx's device integers are 32-bit
(x64 off), and its uint32 info leaves (``map_idx``) are widened to int64,
so the port's int64 leaves become int32 except those.

``rng="native"`` draws with a ``torch.Generator`` on the env's device,
seeded from ``seed`` (0 if None); its trajectories are the port's own.
apx's ``key_impl`` names a TPU hardware RNG with no counterpart here: only
``None`` is accepted. apx's parity-mode overrides of ``use_beam_tables``
and ``glimpse_precision`` have nothing to override: the port has no beam
tables and computes glimpses in float32 for every precision setting.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..core.env import tree_select
from ..core.losses import WeightedLossFn
from ..render import RenderTracker
from ..wrappers.base import APWrapper
from .builders import apply_step_draws, reset_from_draws
from .render_hooks import tracker_slices, update_tracker_reset, update_tracker_step
from .shims import make_shim
from .wire import wire_codec_for

__all__ = ["VectorAdapter", "np_random"]

# apx's uint32 info leaves, which its adapter widens to int64 on the host.
_UINT32_INFO_KEYS = frozenset({"map_idx"})


def np_random(seed: int | None = None) -> tuple[np.random.Generator, int]:
    """gymnasium's ``utils.seeding.np_random``: a PCG64 generator over
    ``SeedSequence(seed)`` and the sequence's entropy."""
    if seed is not None and not (isinstance(seed, int) and 0 <= seed):
        if not isinstance(seed, int):
            raise ValueError(f"Seed must be a python integer, actual type: {type(seed)}")
        raise ValueError(f"Seed must be greater or equal to zero, actual value: {seed}")
    seed_seq = np.random.SeedSequence(seed)
    return np.random.Generator(np.random.PCG64(seed_seq)), seed_seq.entropy


def _flatten(tree, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _flatten(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _flatten(v, out)
    elif tree is not None:
        out.append(tree)


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def _np_tree_map(fn, tree):
    """``fn`` over the array leaves of nested dicts (the host trees)."""
    if isinstance(tree, dict):
        return {k: _np_tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _apx_int_dtype(tree, keep_wide=frozenset()):
    """int64 leaves as int32 (apx's device integers), except the top-level
    keys in ``keep_wide``."""
    def cast(t):
        return t.to(torch.int32) if t.dtype == torch.int64 else t

    if isinstance(tree, dict):
        return {k: (v if k in keep_wide else _apx_int_dtype(v)) for k, v in tree.items()}
    return cast(tree)


class VectorAdapter:
    """Vectorized drop-in core over a port env (unwrapped or TimeLimit-
    wrapped; ``sparse`` composes the reference's Sparsify on the host)."""

    def __init__(
        self,
        env,
        params,
        num_envs: int,
        autoreset: str = "lockstep",  # "lockstep" | "next_step" | "none"
        rng: str = "reference",  # "reference" | "native"
        sparse: bool = False,
        key_impl: str | None = None,
    ):
        if autoreset not in ("lockstep", "next_step", "none"):
            raise ValueError(f"unknown autoreset {autoreset!r}")
        if rng not in ("reference", "native"):
            raise ValueError(f"unknown rng {rng!r}")
        if key_impl is not None:
            raise ValueError(
                f"key_impl={key_impl!r} names a JAX key implementation (apx's 'rbg' is a "
                "TPU hardware RNG); the port draws with torch.Generator and takes only "
                "key_impl=None"
            )
        # Reference info asymmetry: the native vector step template UPDATES
        # the env's info dict (active_perception_vector_env.py:84-111) while
        # the single-env template REPLACES it with a fresh
        # {base_reward, prediction} dict (active_perception_env.py:101-121).
        # Lockstep families are native vector envs (update); LightDark/LIDAR
        # run as singles or SyncVectorEnv-over-singles (replace).
        self.info_mode = "update" if autoreset == "lockstep" else "replace"
        self.env = env
        self.params = params
        self.device = params.device
        self.num_envs = num_envs
        self.autoreset = autoreset
        self.rng = rng
        self.sparse = sparse

        base = env
        while isinstance(base, APWrapper):
            base = base.env
        self.base = base
        self.shim = make_shim(base, params, num_envs) if rng == "reference" else None
        if self.shim is None:
            self.rng = "native"

        self._dense_loss = env.loss_fn(params)
        self.loss = WeightedLossFn(inner=self._dense_loss) if sparse else self._dense_loss

        self._np_random: np.random.Generator | None = None
        self._generator: torch.Generator | None = None
        self._state = None
        self._prev_done = np.zeros(num_envs, dtype=bool)
        self.tracker = RenderTracker()
        self._staging: dict = {}
        codec = wire_codec_for(base, params)
        self._encode, self._wire_decode = codec if codec else (None, None)
        # The step's own draws in reference mode: zeros, as what they feed
        # is overwritten by the host draws (apply_step_draws); none for
        # envs whose step draws nothing.
        g = torch.Generator(device=self.device)
        self._null_step_draws = {k: torch.zeros_like(v)
                                 for k, v in env.draw_step(num_envs, params, g).items()}
        # Per-step timings (``record_timings``): host seconds per phase,
        # device milliseconds from CUDA events, and the transfer's bytes.
        self.record_timings = False
        self.timings: list[dict] = []

    # ------------------------------------------------------------------
    def _ensure_rng(self, seed):
        if seed is not None or (self._np_random is None and self._generator is None):
            if self.rng == "reference":
                if self.autoreset == "next_step" and hasattr(self.shim, "seed_vector"):
                    # SyncVectorEnv semantics: sub-env i is seeded seed+i
                    # and draws from its own stream (SURVEY §3.5).
                    rngs = [np_random(None if seed is None else seed + i)[0]
                            for i in range(self.num_envs)]
                    self._np_random = rngs[0]
                    self.shim.seed_vector(rngs)
                else:
                    self._np_random, _ = np_random(seed)
                    self.shim.seed(self._np_random)
            else:
                self._generator = torch.Generator(device=self.device).manual_seed(
                    0 if seed is None else seed)

    def _derived(self, obs, state):
        d = self.env.obs_derived_from_state(state, self.params)
        return {**obs, **d} if d else obs

    def _native_reset(self, old_state=None):
        env, n, p = self.env, self.num_envs, self.params
        draws = env.draw_reset(n, p, self._generator)
        if old_state is None:
            obs, state, info = env.reset_from_draws(draws, p)
        else:
            obs, state, info = env.autoreset_from_draws(draws, old_state, p)
        return self._derived(obs, state), state, info

    def _pinned(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The pinned staging buffer of leaf ``i`` of this shape and dtype,
        made once and reused (the stream is synchronised before reuse)."""
        key = (i, tuple(t.shape), t.dtype)
        if key not in self._staging:
            self._staging[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return self._staging[key]

    def _to_host(self, tree):
        """One transfer: every leaf copied non_blocking into its pinned
        staging buffer, one synchronisation, then the values copied out into
        numpy arrays the caller owns (on the CPU, copies of the leaves)."""
        leaves: list[torch.Tensor] = []
        _flatten(tree, leaves)
        if self.device.type == "cuda":
            host = [self._pinned(i, t) for i, t in enumerate(leaves)]
            for h, t in zip(host, leaves):
                h.copy_(t, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            arrays = [h.numpy().copy() for h in host]
        else:
            arrays = [t.detach().numpy().copy() for t in leaves]
        if self.record_timings:
            self._mark["bytes"] = sum(t.numel() * t.element_size() for t in leaves)
        return _rebuild(tree, iter(arrays))

    def _wire(self, obs):
        return self._encode(obs) if self._encode is not None else obs

    def _unwire(self, obs_np):
        return self._wire_decode(obs_np) if self._wire_decode is not None else obs_np

    def _event(self, name):
        if self.record_timings and self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._mark[name] = ev

    def _host_mark(self, name):
        if self.record_timings:
            self._mark[name] = time.perf_counter()

    # ------------------------------------------------------------------
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        self._ensure_rng(seed)
        if self.rng == "reference":
            obs, state, info = reset_from_draws(self.env, self.shim.reset_draws(), self.params)
        else:
            obs, state, info = self._native_reset()
        self._state = state
        self._prev_done = np.zeros(self.num_envs, dtype=bool)
        self._mark = {}
        host = self._to_host({
            "obs": self._wire(_apx_int_dtype(obs)),
            "info": _apx_int_dtype(info, _UINT32_INFO_KEYS),
            "first": tracker_slices(self.base, state),
        })
        obs_np = self._unwire(host["obs"])
        update_tracker_reset(self.tracker, self.base, self.params, obs_np, host["first"])
        return obs_np, host["info"]

    # ------------------------------------------------------------------
    def _compose(self, pred, base_reward, term, trunc, info, target, reset_mask):
        """Host loss composition mirroring active_perception_vector_env.py:
        84-111 (+ Sparsify's recomputation, sparsify_wrapper.py:74-88)."""
        base_reward = np.asarray(base_reward, dtype=np.float64)
        dense = self._dense_loss.numpy(np.asarray(pred), target)
        if self.sparse:
            weight = np.asarray(term, dtype=np.float32)
            loss_for_reward = dense * weight
            info_target = {"target": target, "weight": weight}
        else:
            loss_for_reward = dense
            info_target = target
        if reset_mask is not None and self.autoreset == "next_step":
            loss_for_reward = np.where(reset_mask, 0.0, loss_for_reward)
            dense = np.where(reset_mask, 0.0, dense)
            base_reward = np.where(reset_mask, 0.0, base_reward)
        reward = base_reward - loss_for_reward
        env_info = info
        if self.info_mode == "replace":
            # Single-env template semantics: _step's info keys are dropped
            # from step infos; under NEXT_STEP vectorization they re-enter
            # only as the resetting sub-envs' reset info (SyncVectorEnv
            # masked aggregation: zero fill + `_key` validity mask).
            extra = {}
            if reset_mask is not None and reset_mask.any():
                for k, v in env_info.items():
                    m = reset_mask.reshape((-1,) + (1,) * (np.ndim(v) - 1))
                    extra[k] = np.where(m, v, np.zeros_like(v))
                    extra["_" + k] = reset_mask
        else:
            extra = env_info
        if self.info_mode == "replace" and reset_mask is not None and reset_mask.all():
            # Every sub-env reset this step: gymnasium's aggregation emits
            # ONLY the reset infos (no sub-env contributed step keys).
            return reward, extra
        info = {
            **extra,
            "base_reward": base_reward,
            "prediction": {"target": info_target, "loss": dense},
        }
        if self.autoreset == "next_step":
            # Gymnasium SyncVectorEnv info convention: `_key` validity
            # masks, with reset sub-envs' entries zero-filled (they
            # contributed only the reset info).
            provided = (
                ~reset_mask if reset_mask is not None
                else np.ones(self.num_envs, dtype=bool)
            )
            info["prediction"] = {
                "target": _np_tree_map(
                    lambda x: np.where(
                        provided.reshape((-1,) + (1,) * (np.ndim(x) - 1)), x, 0
                    ),
                    info["prediction"]["target"],
                ),
                "_target": provided,
                "loss": info["prediction"]["loss"],
                "_loss": provided,
            }
            info["_base_reward"] = provided
            info["_prediction"] = provided
        return reward, info

    def _fetch_step(self, obs, base_reward, term, trunc, info, target, first):
        self._event("step_done")
        self._host_mark("issued")
        obs = _apx_int_dtype(obs)
        info = _apx_int_dtype(info, _UINT32_INFO_KEYS)
        target = _apx_int_dtype(target)
        if self.record_timings:  # the bytes the transfer would take without the codec
            leaves: list[torch.Tensor] = []
            _flatten((obs, base_reward, term, trunc, info, target, first), leaves)
            self._mark["unencoded_bytes"] = sum(t.numel() * t.element_size() for t in leaves)
        host = self._to_host({
            "obs": self._wire(obs),
            "base_reward": base_reward,
            "term": term,
            "trunc": trunc,
            "info": info,
            "target": target,
            "first": first,
        })
        self._event("copied")
        self._host_mark("fetched")
        return host

    def step(self, actions: dict[str, Any]):
        self._mark = {}
        self._host_mark("start")
        env, p, n, dev = self.env, self.params, self.num_envs, self.device
        pred = actions["prediction"]
        act_t = torch.as_tensor(np.asarray(actions["action"], dtype=np.float32), device=dev)
        pred_t = torch.as_tensor(np.asarray(pred, dtype=np.float32), device=dev)
        self._host_mark("uploaded")
        self._event("step_start")

        if self.autoreset == "lockstep" and self._prev_done.all():
            # Lockstep reset step (image_perception_module.py:197-202 +
            # active_perception_vector_env.py:84-111): base 0, not done,
            # loss vs the env-specific reset target.
            old_state = self._state
            if self.rng == "reference":
                obs, state, info = reset_from_draws(env, self.shim.autoreset_draws(), p)
            else:
                obs, state, info = self._native_reset(old_state)
            target = env.prediction_target_on_reset(old_state, state, p)
            self._state = state
            self._prev_done = np.zeros(n, dtype=bool)
            falses = torch.zeros(n, dtype=torch.bool, device=dev)
            host = self._fetch_step(obs, torch.zeros(n, device=dev), falses, falses, info,
                                    target, tracker_slices(self.base, state))
            zeros = np.zeros(n, dtype=np.float64)
            falses_np = np.zeros(n, dtype=bool)
            reward, info = self._compose(pred, zeros, falses_np, falses_np, host["info"],
                                         host["target"], None)
            self._host_mark("composed")
            obs_np = self._unwire(host["obs"])
            self._host_mark("decoded")
            update_tracker_step(self.tracker, self.base, p, actions, obs_np, info,
                                host["first"], was_reset=True)
            self._finish_timings()
            return obs_np, reward, falses_np, falses_np, info

        reset_draws_host = None
        if self.rng == "reference":
            if self.autoreset == "next_step" and self._prev_done.any() and hasattr(
                    self.shim, "vector_draws"):
                # Per-env conditional draws: each sub-env's stream advances
                # only along its own (step vs reset) branch.
                step_draws, reset_draws_host = self.shim.vector_draws(self._prev_done)
            else:
                step_draws = self.shim.step_draws()
            raw = env.step_env(self._state, act_t, pred_t, p, self._null_step_draws)
            raw = apply_step_draws(env, raw, step_draws, p)
        else:
            raw = env.step_env(self._state, act_t, pred_t, p,
                               env.draw_step(n, p, self._generator))

        reset_mask = None
        raw_obs = self._derived(raw.obs, raw.state)
        if self.autoreset == "next_step" and self._prev_done.any():
            mask = torch.as_tensor(self._prev_done, device=dev)
            if self.rng == "reference":
                draws = (reset_draws_host if reset_draws_host is not None
                         else self.shim.autoreset_draws())
                robs, rstate, rinfo = reset_from_draws(env, draws, p)
            else:
                robs, rstate, rinfo = self._native_reset(self._state)
            if set(rinfo) != set(raw.info):
                raise ValueError(
                    "autoreset info keys differ from step info keys: "
                    f"{sorted(rinfo)} vs {sorted(raw.info)}"
                )
            obs = tree_select(mask, robs, raw_obs)
            state = tree_select(mask, rstate, raw.state)
            info = tree_select(mask, rinfo, raw.info)
            base_reward = torch.where(mask, 0.0, raw.base_reward)
            term = mask.logical_not() & raw.terminated
            trunc = mask.logical_not() & raw.truncated
            reset_mask = self._prev_done
        else:
            obs, state, info = raw_obs, raw.state, raw.info
            base_reward, term, trunc = raw.base_reward, raw.terminated, raw.truncated

        first = tracker_slices(self.base, state, self._state)
        self._state = state
        host = self._fetch_step(obs, base_reward, term, trunc, info, raw.prediction_target,
                                first)
        term_np, trunc_np = host["term"], host["trunc"]
        self._prev_done = term_np | trunc_np
        reward, info = self._compose(pred, host["base_reward"], term_np, trunc_np,
                                     host["info"], host["target"], reset_mask)
        self._host_mark("composed")
        obs_np = self._unwire(host["obs"])
        self._host_mark("decoded")
        update_tracker_step(self.tracker, self.base, p, actions, obs_np, info, host["first"])
        self._finish_timings()
        return obs_np, reward, term_np, trunc_np, info

    def _finish_timings(self):
        if not self.record_timings:
            return
        m = self._mark
        m["tracked"] = time.perf_counter()
        row = {
            "upload_s": m["uploaded"] - m["start"],
            "issue_s": m["issued"] - m["uploaded"],
            "transfer_s": m["fetched"] - m["issued"],
            "compose_s": m["composed"] - m["fetched"],
            "decode_s": m["decoded"] - m["composed"],
            "tracker_s": m["tracked"] - m["decoded"],
            "bytes": m["bytes"],
            "unencoded_bytes": m["unencoded_bytes"],
        }
        if "step_start" in m:
            row["device_step_ms"] = m["step_start"].elapsed_time(m["step_done"])
            row["copy_ms"] = m["step_done"].elapsed_time(m["copied"])
        self.timings.append(row)

    def render(self):
        from ..render import render_env

        return render_env(self.base, self._state, self.params, self.tracker)

    def close(self):
        pass
