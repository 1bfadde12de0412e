"""apx_torch core: spaces, the normalized MSE loss and TimeLimit, held
against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apx.core.losses import MSELossFn as JaxMSE
from apx.envs.common import make_regression_loss_and_target_space as jax_regression

import apx_torch
from apx_torch.core.losses import AffineLossFn, MSELossFn
from apx_torch.core.spaces import ActivePerceptionActionSpace, Box, DictSpace, Image
from apx_torch.envs.common import make_regression_loss_and_target_space

torch.set_num_threads(1)


def test_box_zeros_contains_sample():
    box = Box(low=-1.0, high=1.0, shape=(2,))
    assert box.shape == (2,)
    z = box.zeros(batch_shape=(3,))
    assert z.shape == (3, 2) and z.dtype == torch.float32 and not z.any()
    g = torch.Generator().manual_seed(0)
    x = box.sample(g, batch_shape=(1000,))
    assert x.shape == (1000, 2) and x.min() >= -1.0 and x.max() <= 1.0
    assert box.contains(x[0]) and not box.contains(torch.tensor([2.0, 0.0]))
    clipped = Box(low=0.5, high=1.0, shape=(2,)).zeros()
    assert torch.equal(clipped, torch.full((2,), 0.5))
    with pytest.raises(NotImplementedError):
        Box(shape=(4,)).sample(g, (5,))  # unbounded


def test_image_and_dict_spaces():
    img = Image.create(width=21, height=32, channels=1)
    assert (img.height, img.width, img.channels) == (32, 21, 1)
    assert img.shape == (32, 21, 1) and (img.low, img.high) == (0.0, 1.0)
    d = DictSpace({"a": Box(0.0, 1.0, (2,)), "img": img})
    assert set(d.keys()) == {"a", "img"} and d["img"] is img
    zeros = d.zeros(batch_shape=(2,))
    assert zeros["img"].shape == (2, 32, 21, 1) and d.contains(d.zeros())
    act = ActivePerceptionActionSpace.create(Box(-1.0, 1.0, (2,)), Box(-1.0, 1.0, (2,)))
    assert act.inner_action_space.shape == (2,) and act.prediction_space.shape == (2,)
    assert hash(d) == hash(DictSpace({"img": img, "a": Box(0.0, 1.0, (2,))}))


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMazeStatic-v0"])
def test_lidar_spaces_match_apx(env_id):
    import apx

    venv, params = apx_torch.make_vec(env_id, 2, device="cpu")
    jvenv, jparams = apx.make_vec(env_id, num_envs=2)
    ours = venv.env.observation_space(params)
    ref = jvenv.env.observation_space(jparams)
    assert set(ours.keys()) == set(ref.keys())
    for k in ref.keys():
        assert ours[k].shape == tuple(ref[k].shape), k
        assert (float(ours[k].low), float(ours[k].high)) == (float(ref[k].low), float(ref[k].high))
    for fn in ("inner_action_space", "prediction_space", "prediction_target_space"):
        a, b = getattr(venv.env, fn)(params), getattr(jvenv.env, fn)(jparams)
        assert a.shape == b.shape and (a.low, a.high) == (b.low, b.high), fn


def test_regression_loss_constants_match_apx():
    loss, space = make_regression_loss_and_target_space(2, -1.0, 1.0)
    jloss, jspace = jax_regression(2, -1.0, 1.0)
    assert isinstance(loss, AffineLossFn) and isinstance(loss.inner, MSELossFn)
    assert (loss.scale, loss.offset) == (jloss.scale, jloss.offset)
    assert loss.inner.target_std == jloss.inner.target_std
    assert loss.lower_bound == jloss.lower_bound
    assert loss.blind_guessing_expected_value == jloss.blind_guessing_expected_value
    assert space.shape == tuple(jspace.shape)
    with pytest.raises(ValueError):
        MSELossFn().normalized  # no blind-guess value without target_std


@pytest.mark.parametrize("shape", [(2,), (16, 2), (5, 3)])
def test_mse_normalized_values_and_grads_match_apx(shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    p = rng.uniform(-1.5, 1.5, shape).astype(np.float32)
    t = rng.uniform(-1, 1, shape).astype(np.float32)
    loss = MSELossFn(target_std=float(2 / np.sqrt(12))).normalized
    jloss = JaxMSE(target_std=float(2 / np.sqrt(12))).normalized

    pt = torch.tensor(p, requires_grad=True)
    val = loss(pt, torch.from_numpy(t))
    val.sum().backward()
    jval = jax.jit(jloss)(jnp.asarray(p), jnp.asarray(t))
    jgrad = jax.grad(lambda x: jloss(x, jnp.asarray(t)).sum())(jnp.asarray(p))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgrad), rtol=1e-6)


def test_affine_rounds_scale_to_float32():
    # scale = 1 / (1/3) is 3.0000000000000004 as a Python float; JAX
    # multiplies by its float32 rounding, 3.0.
    loss = make_regression_loss_and_target_space(2, -1.0, 1.0)[0]
    x = torch.tensor([[0.1, 0.7]])
    inner = loss.inner(x, torch.zeros_like(x))
    assert torch.equal(loss(x, torch.zeros_like(x)), inner * 3.0)


@pytest.mark.parametrize("limit", [3, 50, 100])
def test_time_obs_is_two_t_over_limit_minus_one(limit):
    # In apx's jitted step XLA computes 2t/T - 1 as fma(2t, f32(1/T), -1)
    # (pinned bitwise over whole trajectories in test_torch_lidar_env);
    # its float32 reciprocal puts it within two ulps of the exact value.
    from apx_torch.wrappers.time_limit import TimeLimit

    t = np.arange(limit + 1, dtype=np.int32)
    ours = TimeLimit(None, limit, issue_termination=True)._time_obs(torch.from_numpy(t))
    exact = 2.0 * t / limit - 1.0
    assert ours.dtype == torch.float32
    assert np.all(np.abs(ours.numpy() - exact) <= 2 * np.spacing(np.float32(1.0)))
    assert ours[0] == -1.0  # the reset observation


@pytest.mark.parametrize("issue_termination", [True, False])
def test_time_limit_ends_episodes(issue_termination):
    from apx_torch.core.env import AutoResetMode, vector_env
    from apx_torch.data.floor_map import make_rooms_bank
    from apx_torch.envs.lidar_localization import LIDARLocalizationEnv
    from apx_torch.wrappers.time_limit import TimeLimit

    env = TimeLimit(
        LIDARLocalizationEnv(make_rooms_bank(2, device="cpu")), 3,
        issue_termination=issue_termination,
    )
    params = env.default_params()
    venv = vector_env(env, 4, AutoResetMode.NEXT_STEP)
    g = torch.Generator().manual_seed(0)
    obs, state, _ = venv.reset(params, g)
    assert ("time_step" in obs) == issue_termination
    act = {"action": torch.zeros(4, 2), "prediction": torch.zeros(4, 2)}
    dones = []
    for _ in range(4):
        obs, state, r, te, tr, _ = venv.step(state, act, params, g)
        dones.append((te.clone(), tr.clone(), state.inner.t.clone()))
    te3, tr3, t3 = dones[2]
    assert torch.equal(t3, torch.full((4,), 3, dtype=torch.int32))
    assert bool((te3 if issue_termination else tr3).all())
    assert not bool((tr3 if issue_termination else te3).any())
    # The step after the limit is the autoreset step: t back to 0, reward 0.
    te4, tr4, t4 = dones[3]
    assert not bool((te4 | tr4).any()) and not bool(t4.any()) and not bool(r.any())


def test_numerics_round_once():
    from apx_torch.core.numerics import div, fma, sqrt, sum_squares

    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(200_000).astype(np.float32) for _ in range(3))
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    exact = (a.astype(np.longdouble) * b + c).astype(np.float32)  # 64-bit mantissa
    np.testing.assert_array_equal(fma(ta, tb, tc).numpy(), exact)
    x = np.abs(a) * 100
    np.testing.assert_array_equal(sqrt(torch.from_numpy(x)).numpy(), np.sqrt(x))
    np.testing.assert_array_equal(div(ta, 21.0).numpy(), a / np.float32(21.0))
    v = torch.from_numpy(np.stack([a, b], -1))
    np.testing.assert_array_equal(sum_squares(v).numpy(), fma(tb, tb, ta * ta).numpy())
    g = torch.tensor([1.5, -2.0], requires_grad=True)
    fma(g, g, torch.ones(2)).sum().backward()
    assert torch.equal(g.grad, 2 * g.detach())


@pytest.mark.parametrize("classes", [2, 5])
def test_cross_entropy_and_normalized_match_apx(classes):
    """CE and normalized CE against apx's, with the +-1e4-logit edges where
    the softmax saturates; the one-hot pick keeps apx's -0.0."""
    from apx.core.losses import CrossEntropyLossFn as JaxCE

    from apx_torch.core.losses import CrossEntropyLossFn

    rng = np.random.default_rng(classes)
    logits = rng.standard_normal((64, classes)).astype(np.float32) * 3
    logits[:4] = 0.0
    logits[4, :] = -1e4
    logits[4, 0] = 1e4
    logits[5, :] = 1e4
    logits[6, 1] = -1e4
    target = rng.integers(0, classes, 64)
    target[4] = 0  # log-probability exactly 0
    for ours, ref in ((CrossEntropyLossFn(classes), JaxCE(classes)),
                      (CrossEntropyLossFn(classes).normalized, JaxCE(classes).normalized)):
        got = ours(torch.from_numpy(logits), torch.from_numpy(target))
        want = np.asarray(jax.jit(ref)(jnp.asarray(logits), jnp.asarray(target)))
        assert got.dtype == torch.float32 and got.shape == (64,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(want))
    norm = CrossEntropyLossFn(classes).normalized
    assert norm.scale == JaxCE(classes).normalized.scale
    assert norm.blind_guessing_expected_value == pytest.approx(1.0)
    # Uniform logits are the blind guess: normalized loss 1.
    np.testing.assert_allclose(norm(torch.zeros(3, classes), torch.zeros(3)).numpy(), 1.0,
                               rtol=1e-6)
    assert CrossEntropyLossFn().blind_guessing_expected_value is None


def test_discrete_and_logit_spaces():
    from apx_torch.core.spaces import Discrete, Logit

    d = Discrete(3)
    assert d.shape == () and d.dtype == torch.int32
    g = torch.Generator().manual_seed(0)
    x = d.sample(g, batch_shape=(500,))
    assert x.shape == (500,) and x.dtype == torch.int32
    assert set(x.tolist()) == {0, 1, 2}
    assert torch.equal(d.zeros((4,)), torch.zeros(4, dtype=torch.int32))
    assert d.contains(2) and not d.contains(3) and not d.contains(-1)
    logit = Logit(low=-np.inf, high=np.inf, shape=(2,))
    assert isinstance(logit, Box) and logit.shape == (2,)
    assert logit.zeros((5,)).shape == (5, 2)
    assert hash(d) == hash(Discrete(3)) and d != Discrete(4)


@pytest.mark.parametrize("env_id", ["CircleSquare-v0", "CircleSquareInverted-s20-v0"])
def test_image_spaces_match_apx(env_id):
    import apx

    venv, params = apx_torch.make_vec(env_id, 2, device="cpu")
    jvenv, jparams = apx.make_vec(env_id, num_envs=2)
    ours = venv.env.observation_space(params)
    ref = jvenv.env.observation_space(jparams)
    assert set(ours.keys()) == set(ref.keys())
    for k in ref.keys():
        assert ours[k].shape == tuple(ref[k].shape), k
        assert type(ours[k]).__name__ == type(ref[k]).__name__, k
    assert venv.env.prediction_space(params).shape == tuple(jvenv.env.prediction_space(jparams).shape)
    assert venv.env.prediction_target_space(params).n == jvenv.env.prediction_target_space(jparams).n
    assert type(venv.env.prediction_space(params)).__name__ == "Logit"
