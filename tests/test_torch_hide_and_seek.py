"""CircleSquare hide-and-seek in the port against apx: both ids and their
``-sparse`` twins stepped (``step`` and ``boundary_reset_step``) with the
same actions, logits and reset draws (base rewards bitwise, rewards within
1e-6, the classification tier), the masked prediction's info quirks, the
episodic rollout against the plain one, ``make`` through
``VectorToSingle`` (the masked spaces and zero loss), and the rounding
sites of the added reward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apx

import apx_torch
from apx_torch.core.env import rollout, rollout_episodic, with_autoreset
from apx_torch.core.losses import ZeroLossFn
from apx_torch.core.numerics import fma, sqrt
from apx_torch.core.spaces import TupleSpace
from apx_torch.envs import circle_square_hide_and_seek as hs
from apx_torch.ops.glimpse import sensor_pos_lim_pixels
from apx_torch.wrappers.metrics import ClassificationMetrics
from apx_torch.wrappers.vector_to_single import VectorToSingle

torch.set_num_threads(1)
TOL = 1e-6
N = 8
PERIOD = 32  # the ids' step limit
IDS = ["CircleSquareHideAndSeek-v0", "CircleSquareHideAndSeekNoPrediction-v0",
       "CircleSquareHideAndSeek-sparse-v0", "CircleSquareHideAndSeekNoPrediction-sparse-v0"]


def _draw_fn(params):
    def one(key):
        k_idx, _, k_pos = jax.random.split(key, 3)
        idx = jax.random.randint(k_idx, (), 0, params.dataset.length, dtype=jnp.int32)
        return idx, jax.random.uniform(k_pos, (2,), minval=-1.0, maxval=1.0)

    batched = jax.jit(jax.vmap(one))

    def draws(keys):
        idx, pos = batched(keys)
        return {"index": torch.from_numpy(np.array(idx, dtype=np.int64)),
                "inverted": torch.zeros(N, dtype=torch.bool), "pos": torch.from_numpy(np.array(pos))}

    return draws


def _apx_trajectory(env_id, steps):
    """apx's jitted trajectory: per step the action, the logits, the reset
    draws its key gives, and its outputs. Step ``PERIOD`` of each cycle is
    ``boundary_reset_step``."""
    jvenv, jp = apx.make_vec(env_id, num_envs=N)
    draws = _draw_fn(jp)
    key = jax.random.PRNGKey(3)
    out = jax.jit(jvenv.reset)(key, jp)
    first = (draws(jax.random.split(key, N)), out)
    step, boundary = jax.jit(jvenv.step), jax.jit(jvenv.boundary_reset_step)
    rng = np.random.default_rng(1)
    js = out[1]
    traj = []
    for t in range(steps):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32)
        logits = rng.standard_normal((N, 2)).astype(np.float32)
        fn = boundary if t % (PERIOD + 1) == PERIOD else step
        res = fn(kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(logits)}, jp)
        js = res[1]
        traj.append((act, logits, draws(jax.random.split(jax.random.split(kt)[1], N)), res))
    return first, traj


@pytest.fixture(scope="module", params=IDS)
def apx_run(request):
    return request.param, *_apx_trajectory(request.param, PERIOD + 3)


def _run_port(env_id, first, traj):
    venv, p = apx_torch.make_vec(env_id, N, device="cpu")
    obs, s, info = venv.reset(p, draws=first[0])
    outs = [(obs, info)]
    for t, (act, logits, draws, _) in enumerate(traj):
        full = {"action": torch.from_numpy(act), "prediction": torch.from_numpy(logits)}
        fn = venv.boundary_reset_step if t % (PERIOD + 1) == PERIOD else venv.step
        obs, s, r, te, tr, info = fn(s, full, p, reset_draws=draws)
        outs.append((obs, s, r, te, tr, info))
    return outs


def test_trajectory_matches_apx(apx_run):
    env_id, first, traj = apx_run
    outs = _run_port(env_id, first, traj)
    masked = "NoPrediction" in env_id
    _, (jobs0, _, jinfo0) = first
    # Only the masked reset's info carries a prediction entry: the empty target.
    assert ("prediction" in jinfo0) == ("prediction" in outs[0][1]) == masked
    if masked:
        assert jinfo0["prediction"]["target"] == () == outs[0][1]["prediction"]["target"]
    for t, ((*_, (jobs, js, jr, jte, jtr, ji)), (obs, s, r, te, tr, info)) in enumerate(
            zip(traj, outs[1:])):
        what = f"{env_id} step {t}"
        np.testing.assert_array_equal(np.asarray(jobs["glimpse_pos"]), obs["glimpse_pos"].numpy())
        np.testing.assert_array_equal(np.asarray(ji["base_reward"]), info["base_reward"].numpy(),
                                      err_msg=f"{what} base reward")
        err = np.abs(np.asarray(jr, dtype=np.float64) - r.numpy()).max()
        assert err <= TOL, f"{what} reward {err}"
        if masked:  # the reward is the augmented base reward: bitwise
            np.testing.assert_array_equal(np.asarray(jr), r.numpy(), err_msg=what)
        np.testing.assert_array_equal(np.asarray(jte), te.numpy(), err_msg=what)
        np.testing.assert_array_equal(np.asarray(js.inner.pos), s.inner.pos.numpy())
        np.testing.assert_array_equal(np.asarray(js.prev_done), s.prev_done.numpy())
        jt, tt = ji["prediction"]["target"], info["prediction"]["target"]
        empty = lambda x: isinstance(x, tuple) and x == ()  # noqa: E731
        assert isinstance(jt, dict) == isinstance(tt, dict) and empty(jt) == empty(tt)
        if isinstance(tt, dict):  # sparse: the empty target nests in the weight dict
            assert empty(jt["target"]) == empty(tt["target"]) == masked and set(jt) == set(tt)
            np.testing.assert_array_equal(np.asarray(jt["weight"]), tt["weight"].numpy())
        # The CE of the (zero) logits stays in info, masked or not.
        err = np.abs(np.asarray(ji["prediction"]["loss"]) - info["prediction"]["loss"].numpy()).max()
        assert err <= TOL, what


def _policy(gen, obs):
    n = obs["glimpse"].shape[0]
    return {"action": torch.rand((n, 2), generator=gen) * 2 - 1,
            "prediction": torch.randn((n, 2), generator=gen)}


@pytest.mark.parametrize("env_id", ["CircleSquareHideAndSeek-v0",
                                    "CircleSquareHideAndSeekNoPrediction-sparse-v0"])
def test_rollout_episodic_bitwise_equal_to_rollout(env_id):
    """``with_autoreset`` recurses through the wrapper (and a metrics
    wrapper over it), and the hoisted boundary gives the plain LOCKSTEP
    loop's trajectory bitwise."""
    venv, p = apx_torch.make_vec(env_id, 4, device="cpu", metrics=True)
    inner = with_autoreset(venv, apx_torch.AutoResetMode.DISABLED)
    hide = inner.venv if hasattr(inner, "buffer_len") else inner
    assert hide.venv.autoreset is apx_torch.AutoResetMode.DISABLED
    a = rollout(venv, p, _policy, torch.Generator().manual_seed(9), 70)
    b = rollout_episodic(venv, p, _policy, torch.Generator().manual_seed(9), 70, PERIOD)
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k


def test_make_goes_through_vector_to_single():
    """``make`` of a HideAndSeek id is ``VectorToSingle`` over a one-env
    vector pipeline; its spaces and loss are the wrapper's: the masked id
    has apx's empty prediction space and zero loss."""
    for env_id, masked in (("CircleSquareHideAndSeek-v0", False),
                           ("CircleSquareHideAndSeekNoPrediction-v0", True)):
        single, p = apx_torch.make(env_id, device="cpu")
        jsingle, jp = apx.make(env_id)
        assert isinstance(single, VectorToSingle) and type(jsingle).__name__ == "VectorToSingle"
        space, jspace = single.prediction_space(p), jsingle.prediction_space(jp)
        assert type(space).__name__ == type(jspace).__name__
        assert type(single.loss_fn(p)).__name__ == type(jsingle.loss_fn(jp)).__name__
        assert single.inner_action_space(p).shape == tuple(jsingle.inner_action_space(jp).shape)
        if masked:
            assert space == TupleSpace(()) and jspace.spaces == ()
            assert isinstance(single.loss_fn(p), ZeroLossFn)
        else:
            assert space.shape == (2,) == tuple(jspace.shape)
        g = torch.Generator().manual_seed(0)
        obs, s, info = single.reset(p, g)
        assert obs["glimpse"].shape == (5, 5, 1)
        act = {"action": torch.tensor([0.3, -0.2]),
               "prediction": () if masked else torch.zeros(2)}
        obs, s, r, te, tr, info = single.step(s, act, p, g)
        assert r.shape == () and te.shape == ()


def test_metrics_wrap_as_apx():
    for env_id in IDS:
        venv, _ = apx_torch.make_vec(env_id, 2, device="cpu", metrics=True)
        jvenv, _ = apx.make_vec(env_id, num_envs=2, metrics=True)
        assert type(venv).__name__ == type(jvenv).__name__
        assert isinstance(venv, ClassificationMetrics) == ("NoPrediction" not in env_id)


def _pos_norm_division(self, params, indices):
    h, w, _ = params.dataset.image_shape
    indices = indices.to(torch.int64)
    rem = indices // 2
    pos = torch.stack([rem % w, rem // w], dim=-1).to(torch.float32)
    lim = torch.from_numpy(sensor_pos_lim_pixels((h, w), params.sensor_size, params.sensor_scale))
    return pos / lim - 1.0, ((indices % 2) * 2 - 1).to(torch.float32)


def _pos_norm_unfused(self, params, indices):
    pos_norm, sign = _ORIGINAL(self, params, indices)
    h, w, _ = params.dataset.image_shape
    rem = indices.to(torch.int64) // 2
    pos = torch.stack([rem % w, rem // w], dim=-1).to(torch.float32)
    lim = sensor_pos_lim_pixels((h, w), params.sensor_size, params.sensor_scale)
    return pos * torch.from_numpy(np.float32(1.0) / lim) - 1.0, sign


def _norm_unfused(x):
    return sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


_ORIGINAL = hs.CircleSquareHideAndSeek._object_pos_norm_and_sign

# site -> (what is replaced, replacement, whether base rewards change)
_SITES = {
    "pos / lim - 1: fma(x, 1/lim, -1) -> true division": (
        "_object_pos_norm_and_sign", _pos_norm_division, True),
    "pos / lim - 1: fma -> x * (1/lim) - 1": ("_object_pos_norm_and_sign", _pos_norm_unfused, True),
    "|glimpse_pos - pos| contracted -> unfused": ("norm2", _norm_unfused, True),
    # sign is +-1, so sign * distance is exact: contracted or not, the same.
    "sign * d + r -> fma(sign, d, r)": ("sign", None, False),
}


@pytest.fixture(scope="module")
def apx_masked_run():
    return _apx_trajectory("CircleSquareHideAndSeekNoPrediction-v0", 2 * (PERIOD + 1))


@pytest.mark.parametrize("site", ["as written", *_SITES])
def test_hide_and_seek_rounding_sites(apx_masked_run, monkeypatch, site):
    """The masked id's rewards (the augmented base reward) equal apx's on
    every step; written any other way, each site makes some differ."""
    first, traj = apx_masked_run
    differs = False
    if site != "as written":
        name, fn, differs = _SITES[site]
        if name == "norm2":
            monkeypatch.setattr(hs, "norm2", fn)
        elif name == "sign":
            def augment(self, params, obs, reward, info):
                pos_norm, sign = self._object_pos_norm_and_sign(params, info["index"])
                base = fma(sign, hs.norm2(obs["glimpse_pos"] - pos_norm), info["base_reward"])
                return base, {**info, "base_reward": base,
                              "prediction": {**info["prediction"], "target": ()}}
            monkeypatch.setattr(hs.CircleSquareHideAndSeek, "_augment", augment)
        else:
            monkeypatch.setattr(hs.CircleSquareHideAndSeek, name, fn)
    outs = _run_port("CircleSquareHideAndSeekNoPrediction-v0", first, traj)
    differing = sum(not np.array_equal(np.asarray(j[3][2]), o[2].numpy())
                    for j, o in zip(traj, outs[1:]))
    assert (differing > 0) == differs, differing


def test_wrapper_is_a_frozen_dataclass_over_venv():
    venv, _ = apx_torch.make_vec("CircleSquareHideAndSeek-v0", 2, device="cpu")
    assert isinstance(venv, hs.CircleSquareHideAndSeek)
    assert [f.name for f in dataclasses.fields(venv)] == ["venv", "mask_prediction"]
    assert venv.autoreset is apx_torch.AutoResetMode.LOCKSTEP and venv.num_envs == 2
