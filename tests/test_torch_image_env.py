"""The port's slice 2 as a whole: apx_torch's CircleSquare envs under
LOCKSTEP autoreset against apx's, stepped with the same actions, logits and
reset draws.

apx draws resets from threefry keys; the test computes the draws those
keys give, with the calls apx's ``VectorAPEnv.step`` and
``ImagePerceptionEngine.reset`` make (``k_idx, k_inv, k_pos = split(key,
3)``), and injects them into the port. States, dones and the non-glimpse
observations are bitwise apx's; glimpses and rewards are held to 1e-6
absolute (measured max on these trajectories: 6.0e-8 glimpse, 4.8e-7 reward;
XLA's and PyTorch's log-softmax round exp and log differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apx
from apx.compat.builders import reset_from_draws as jax_reset_from_draws
from apx.core.env import AutoResetMode as JaxMode
from apx.data.circle_square import make_circle_square_bank as jax_bank
from apx.data.dataset import BankImageDataset as JaxBank

import apx_torch
from apx_torch.compat.builders import reset_from_draws
from apx_torch.convert import image_bank_from_numpy, image_state_from_numpy
from apx_torch.core.env import AutoResetMode, VectorState, rollout, rollout_episodic
from apx_torch.data.circle_square import make_circle_square_bank
from apx_torch.envs.image_classification import ImageClassificationEnv

torch.set_num_threads(1)
N = 16
TOL = 1e-6


def _draw_fn(params):
    """keys -> the (index, inverted, pos) draws apx's reset makes from each key."""

    def one(key):
        k_idx, k_inv, k_pos = jax.random.split(key, 3)
        idx = jax.random.randint(k_idx, (), 0, params.dataset.length, dtype=jnp.int32)
        if params.randomly_invert_labels:
            inv = jax.random.randint(k_inv, (), 0, 2) == 1
        else:
            inv = jnp.zeros((), dtype=jnp.bool_)
        return idx, inv, jax.random.uniform(k_pos, (2,), minval=-1.0, maxval=1.0)

    batched = jax.jit(jax.vmap(one))

    def draws(keys):
        idx, inv, pos = batched(keys)
        return {"index": torch.from_numpy(np.array(idx, dtype=np.int64)),
                "inverted": torch.from_numpy(np.array(inv)),
                "pos": torch.from_numpy(np.array(pos))}

    return draws


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


def _close(a, b, what):
    err = np.abs(np.asarray(a, dtype=np.float64) - b.numpy()).max()
    assert err <= TOL, f"{what}: max |diff| {err}"


def _check_state(js, s, what):
    ji, ti = js.inner, s.inner
    _eq(ji.pos, ti.pos, f"{what} pos")
    _eq(ji.time, ti.time, f"{what} time")
    _eq(np.asarray(ji.label).astype(np.int64), ti.label, f"{what} label")
    _eq(np.asarray(ji.data_index).astype(np.int64), ti.data_index, f"{what} data_index")
    _eq(ji.label_inverted, ti.label_inverted, f"{what} label_inverted")
    _eq(ji.image, ti.image, f"{what} image")
    _eq(js.prev_done, s.prev_done, f"{what} prev_done")


def _check_obs(jobs, obs, what):
    assert set(jobs) == set(obs), what
    for k in jobs:
        if k == "glimpse":
            _close(jobs[k], obs[k], f"{what} glimpse")
        else:
            _eq(jobs[k], obs[k], f"{what} obs {k}")


@pytest.mark.parametrize("env_id,overrides", [
    ("CircleSquare-v0", {}),
    ("CircleSquareInverted-v0", {}),
    ("CircleSquare-s15-nograd-v0", {"step_limit": 7}),  # time obs at a non-power of two
])
def test_lockstep_trajectory_matches_apx(env_id, overrides):
    jvenv, jp = apx.make_vec(env_id, num_envs=N, **overrides)
    venv, p = apx_torch.make_vec(env_id, N, device="cpu", **overrides)
    assert venv.autoreset is AutoResetMode.LOCKSTEP and jvenv.autoreset is JaxMode.LOCKSTEP
    key = jax.random.PRNGKey(5)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    draws = _draw_fn(jp)
    obs, s, _ = venv.reset(p, draws=draws(jax.random.split(key, N)))
    _check_obs(jobs, obs, "reset")
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(1)
    period = p.step_limit + 1
    resets = 0
    for t in range(3 * period):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32)
        logits = rng.standard_normal((N, 2)).astype(np.float32)
        jobs, js, jr, jte, jtr, _ = step(
            kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(logits)}, jp)
        _, reset_key = jax.random.split(kt)  # apx's VectorAPEnv.step split
        obs, s, r, te, tr, _ = venv.step(
            s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(logits)}, p,
            reset_draws=draws(jax.random.split(reset_key, N)))
        what = f"{env_id} step {t}"
        _check_obs(jobs, obs, what)
        _check_state(js, s, what)
        _eq(jte, te, f"{what} terminated")
        _eq(jtr, tr, f"{what} truncated")
        _close(jr, r, f"{what} reward")
        resets += int((s.inner.time == 0).all())
    assert resets == 3  # every env went through three LOCKSTEP resets


@pytest.mark.parametrize("size,gradient", [(28, True), (15, False), (20, True)])
def test_bank_bitwise_equal_to_apx(size, gradient):
    ours = make_circle_square_bank((size, size), show_gradient=gradient, device="cpu")
    ref = jax_bank((size, size), show_gradient=gradient)
    assert ours.length == ref.length == 2 * size * size
    assert ours.num_classes == ref.num_classes and ours.image_shape == tuple(ref.image_shape)
    _eq(ref.images, ours.images, "images")
    _eq(np.asarray(ref.labels).astype(np.int64), ours.labels, "labels")


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_image_bank_from_numpy_matches_apx_fetch(dtype):
    """convert carries apx's banks across: int32-packed uint8 rows are
    unpacked on the host; fetch_raw gives apx's bytes and labels."""
    rng = np.random.default_rng(3)
    if dtype == "uint8":
        images = rng.integers(0, 256, (40, 12, 8, 3), dtype=np.uint8)
    else:
        images = rng.random((40, 12, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 40)
    ref = JaxBank.from_numpy(images, labels, 5)
    assert (ref.packed_shape is not None) == (dtype == "uint8")
    ours = image_bank_from_numpy(np.asarray(ref.images), np.asarray(ref.labels), ref.n_classes,
                                 packed_shape=ref.packed_shape, device="cpu")
    idx = rng.integers(0, 40, 17)
    jimg, jlab = jax.vmap(ref.fetch_raw)(jnp.asarray(idx))
    img, lab = ours.fetch_raw(torch.from_numpy(idx))
    assert img.dtype == (torch.uint8 if dtype == "uint8" else torch.float32)
    _eq(jimg, img, "images")
    _eq(np.asarray(jlab).astype(np.int64), lab, "labels")
    jf, _ = jax.vmap(ref.fetch)(jnp.asarray(idx))
    _close(jf, ours.fetch(torch.from_numpy(idx))[0], "fetch (float32)")


def _policy(n):
    def policy(gen, obs):
        return {"action": torch.rand((n, 2), generator=gen) * 2 - 1,
                "prediction": torch.randn((n, 2), generator=gen)}

    return policy


@pytest.mark.parametrize("num_steps", [3, 35, 40])
def test_rollout_episodic_bitwise_equal_to_step_loop(num_steps):
    """The hoisted boundary (DISABLED steps + boundary_reset_step) gives the
    plain LOCKSTEP loop's trajectory bitwise, partial last cycle included."""
    venv, p = apx_torch.make_vec("CircleSquareInverted-s15-v0", 8, device="cpu")
    outs = [fn(venv, p, _policy(8), torch.Generator().manual_seed(9), num_steps, *extra)
            for fn, extra in ((rollout, ()), (rollout_episodic, (p.step_limit,)))]
    (obs_a, s_a, traj_a), (obs_b, s_b, traj_b) = outs
    for a, b in zip(traj_a, traj_b):
        assert torch.equal(a, b)
    for k in obs_a:
        assert torch.equal(obs_a[k], obs_b[k]), k
    for f in dataclasses.fields(s_a.inner):
        assert torch.equal(getattr(s_a.inner, f.name), getattr(s_b.inner, f.name)), f.name
    assert torch.equal(s_a.prev_done, s_b.prev_done)
    if num_steps >= 17:
        assert traj_a[1][15].all() and not traj_a[1][16].any()  # done at 16, reset at 17


def test_boundary_reset_step_equals_all_done_step():
    venv, p = apx_torch.make_vec("CircleSquare-s20-v0", 6, device="cpu")
    g = torch.Generator().manual_seed(2)
    obs, s, _ = venv.reset(p, g)
    s = VectorState(inner=s.inner, prev_done=torch.ones(6, dtype=torch.bool))
    act = _policy(6)(g, obs)
    draws = venv.env.draw_reset(6, p, g)
    a = venv.step(s, act, p, reset_draws=draws)
    b = venv.boundary_reset_step(s, act, p, reset_draws=draws)
    for x, y in zip(a[2:5], b[2:5]):
        assert torch.equal(x, y)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[5]["prediction"]["loss"], b[5]["prediction"]["loss"])
    assert torch.equal(a[5]["index"], b[5]["index"])


def test_state_carried_across_with_convert():
    """Start the port from apx's mid-episode state (convert) and step both."""
    jvenv, jp = apx.make_vec("CircleSquareInverted-v0", num_envs=N)
    venv, p = apx_torch.make_vec("CircleSquareInverted-v0", N, device="cpu")
    key = jax.random.PRNGKey(3)
    _, js, _ = jax.jit(jvenv.reset)(key, jp)
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(4)
    for t in range(16):  # ends on the all-done step: the next one resets
        act = {"action": jnp.asarray(rng.uniform(-1, 1, (N, 2)), jnp.float32),
               "prediction": jnp.zeros((N, 2))}
        _, js, *_ = step(jax.random.fold_in(key, t), js, act, jp)
    i = js.inner
    for k in (5, 16):
        s = image_state_from_numpy(i.image, i.label, i.data_index, i.pos, i.time,
                                   i.label_inverted, js.prev_done, device="cpu")
        act = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
        logits = rng.standard_normal((N, 2)).astype(np.float32)
        kt = jax.random.fold_in(key, 100 + k)
        jobs, js2, jr, jte, *_ = step(
            kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(logits)}, jp)
        obs, s2, r, te, *_ = venv.step(
            s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(logits)}, p,
            reset_draws=_draw_fn(jp)(jax.random.split(jax.random.split(kt)[1], N)))
        _check_obs(jobs, obs, f"convert {k}")
        _check_state(js2, s2, f"convert {k}")
        _eq(jte, te, "terminated")
        _close(jr, r, "reward")
        js, i = js2, js2.inner


def test_reset_from_host_draws_matches_apx_builder():
    jvenv, jp = apx.make_vec("CircleSquareInverted-v0", num_envs=4)
    venv, p = apx_torch.make_vec("CircleSquareInverted-v0", 4, device="cpu")
    draws = {"index": np.array([0, 7, 1567, 300], np.int32),
             "inverted": np.array([True, False, True, False]),
             "pos": np.array([[-1, -1], [1, 1], [0.25, -0.5], [0.9, 0.1]], np.float32)}
    jobs, js, jinfo = jax.jit(lambda d: jax_reset_from_draws(jvenv.env, d, jp))(draws)
    obs, s, info = reset_from_draws(venv.env, draws, p)
    _check_obs(jobs, obs, "reset")
    _eq(np.asarray(js.label).astype(np.int64), s.label, "label")
    _eq(js.label_inverted, s.label_inverted, "label_inverted")
    _eq(js.image, s.image, "image")
    _eq(np.asarray(jinfo["index"]).astype(np.int64), info["index"], "index")


@pytest.mark.parametrize("env_id", ["CircleSquare-v0", "CircleSquareInverted-s15-v0"])
def test_native_draws_in_range(env_id):
    """Without injected draws the port draws from its own generator: bank
    indices in [0, D), start positions in [-1, 1)^2, inversions only where
    the env inverts labels."""
    venv, p = apx_torch.make_vec(env_id, 512, device="cpu")
    g = torch.Generator().manual_seed(5)
    d = venv.env.draw_reset(512, p, g)
    assert d["index"].min() >= 0 and d["index"].max() < p.dataset.length
    assert d["pos"].min() >= -1.0 and d["pos"].max() < 1.0 and d["pos"].std() > 0.5
    assert torch.unique(d["index"]).numel() > 256  # spread over the bank
    if p.randomly_invert_labels:
        assert 100 < int(d["inverted"].sum()) < 412
    else:
        assert not d["inverted"].any()
    obs, s, _ = venv.reset(p, g)
    label = p.dataset.labels[s.inner.data_index]
    want = torch.where(s.inner.label_inverted, 1 - label, label)
    assert torch.equal(s.inner.label, want)
    assert obs["glimpse"].shape == (512, 5, 5, 1)
    assert obs["glimpse"].min() >= 0 and obs["glimpse"].max() <= 1


def test_lockstep_invariants():
    """apx's LOCKSTEP contract (tests/test_env_core.py): zero actions and
    zero logits give base reward 0 and normalized loss 1; after the
    all-done step comes the reset step with terminated False, base reward
    0, the loss against the new label and the time obs back at -1."""
    env = ImageClassificationEnv(dataset=make_circle_square_bank((15, 15), device="cpu"),
                                 step_limit=2)
    p = env.default_params()
    venv = apx_torch.vector_env(env, 2, AutoResetMode.LOCKSTEP)
    g = torch.Generator().manual_seed(2)
    obs, s, _ = venv.reset(p, g)
    act = {"action": torch.zeros(2, 2), "prediction": torch.zeros(2, 2)}
    obs, s, r1, te1, _, info1 = venv.step(s, act, p, g)
    assert torch.equal(info1["base_reward"], torch.zeros(2)) and not te1.any()
    np.testing.assert_allclose(info1["prediction"]["loss"].numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(r1.numpy(), -1.0, rtol=1e-6)
    obs, s, r2, te2, _, _ = venv.step(s, act, p, g)
    assert te2.all()
    obs, s, r3, te3, tr3, info3 = venv.step(s, act, p, g)
    assert not (te3 | tr3).any() and torch.equal(info3["base_reward"], torch.zeros(2))
    assert torch.equal(info3["prediction"]["target"], s.inner.label)
    np.testing.assert_allclose(r3.numpy(), -1.0, rtol=1e-6)
    assert torch.equal(obs["time_step"], torch.full((2,), -1.0))
    # An action of norm > 1 is projected onto the unit circle.
    p0 = obs["glimpse_pos"]
    obs, s, *_, info = venv.step(s, {"action": torch.full((2, 2), 2.0),
                                     "prediction": torch.zeros(2, 2)}, p, g)
    np.testing.assert_allclose(obs["glimpse_pos"].numpy(),
                               np.clip(p0.numpy() + 0.2 / np.sqrt(2), -1, 1), atol=1e-6)
    np.testing.assert_allclose(info["base_reward"].numpy(), -np.sqrt(8) * 1e-3, rtol=1e-5)
