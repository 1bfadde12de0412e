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
    # Unbounded: gymnasium's standard normal (the ported rule).
    x = Box(shape=(4,)).sample(g, (5000,))
    assert x.shape == (5000, 4) and x.dtype == torch.float32 and torch.isfinite(x).all()
    assert abs(float(x.mean())) < 0.05 and abs(float(x.std()) - 1.0) < 0.05
    assert Box(shape=(4,)).contains(x[0])


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


def test_box_sample_distribution():
    """gymnasium's rule, by moments at 4096 x 8 samples from a fixed seed
    (threefry draws cannot be matched): N(0, 1) on unbounded axes, low +
    Exp(1) and high - Exp(1) on half-bounded ones, uniform on bounded ones."""
    low = np.array([-np.inf, 0.5, -np.inf, -1.0, 2.0], np.float32)
    high = np.array([np.inf, np.inf, -0.25, 3.0, 2.5], np.float32)
    box = Box(low=low, high=high, shape=(5,))
    x = box.sample(torch.Generator().manual_seed(0), (4096, 8)).reshape(-1, 5).double()
    mean, std = x.mean(0).numpy(), x.std(0).numpy()
    want_mean = [0.0, 1.5, -1.25, 1.0, 2.25]
    want_std = [1.0, 1.0, 1.0, 4 / 12 ** 0.5, 0.5 / 12 ** 0.5]
    np.testing.assert_allclose(mean, want_mean, atol=0.03)
    np.testing.assert_allclose(std, want_std, rtol=0.03)
    assert x[:, 1].min() >= 0.5 and x[:, 2].max() <= -0.25
    assert x[:, 3].min() >= -1 and x[:, 3].max() <= 3 and x[:, 4].min() >= 2 and x[:, 4].max() <= 2.5
    assert (x[:, 0] < -2).any() and (x[:, 0] > 2).any()
    assert all(box.contains(row) for row in x[:50].float())


def test_space_sample_device_follows_generator():
    g = torch.Generator().manual_seed(1)
    for space in (Box(-1.0, 1.0, (2,)), Box(shape=(2,))):
        assert space.sample(g).device == g.device
        assert space.sample(g, (3,), device="cpu").shape == (3, 2)
    from apx_torch.core.spaces import Discrete, MultiDiscrete

    assert Discrete(4).sample(g, (3,)).device == g.device
    assert MultiDiscrete((2, 3)).sample(g, (3,)).device == g.device


def test_spaces_match_apx():
    """Array-bound boxes (nested tuples), MultiDiscrete, TupleSpace and
    batch_space against apx's."""
    from apx.core import spaces as js

    from apx_torch.core import spaces as ts

    low = np.array([-1.0, 0.0, -np.inf], np.float32)
    high = np.array([1.0, 2.0, np.inf], np.float32)
    ours, ref = ts.Box(low=low, high=high, shape=(3,)), js.Box(low=low, high=high, shape=(3,))
    assert ours.low == ref.low and ours.high == ref.high and isinstance(ours.low, tuple)
    assert hash(ours) == hash(ts.Box(low=list(low), high=list(high), shape=(3,)))
    np.testing.assert_array_equal(ours.low_arr, ref.low_arr)
    md, jmd = ts.MultiDiscrete((2, 5, 3)), js.MultiDiscrete((2, 5, 3))
    assert md.shape == jmd.shape and md.contains([1, 4, 2]) and not md.contains([2, 0, 0])
    s = md.sample(torch.Generator().manual_seed(2), (2000,))
    assert s.dtype == torch.int32 and (s.amax(0).tolist() == [1, 4, 2]) and s.min() == 0
    tup = ts.TupleSpace((ts.Box(-1.0, 1.0, (2,)), ts.Discrete(3)))
    assert tup.contains((torch.zeros(2), 1)) and not tup.contains((torch.zeros(2),))
    assert ts.TupleSpace(()).sample(torch.Generator()) == ()

    def same(a, b):
        assert type(a).__name__ == type(b).__name__
        if isinstance(a, ts.DictSpace):
            assert set(a.keys()) == set(b.keys())
            for k in a.keys():
                same(a[k], b[k])
        elif isinstance(a, ts.TupleSpace):
            for x, y in zip(a.spaces, b.spaces, strict=True):
                same(x, y)
        elif isinstance(a, ts.MultiDiscrete):
            assert a.nvec == b.nvec
        else:
            assert a.shape == tuple(b.shape) and a.low == b.low and a.high == b.high

    for mk in (lambda m: m.Box(low=low, high=high, shape=(3,)),
               lambda m: m.Box(-1.0, 1.0, (2,)),
               lambda m: m.Discrete(4),
               lambda m: m.MultiDiscrete((2, 7)),
               lambda m: m.TupleSpace((m.Discrete(2), m.Box(0.0, 1.0, (1,)))),
               lambda m: m.ActivePerceptionActionSpace.create(m.Box(-1.0, 1.0, (2,)),
                                                              m.Logit(shape=(2,))),
               lambda m: m.DictSpace({"a": m.Image.create(4, 3, 1), "b": m.Discrete(2)})):
        same(ts.batch_space(mk(ts), 3), js.batch_space(mk(js), 3))


def test_weighted_and_zero_losses_match_apx():
    """apx's tests/test_losses.py:73-90, against apx's losses."""
    from apx.core.losses import MSELossFn as JMSE
    from apx.core.losses import WeightedLossFn as JWeighted
    from apx.core.losses import ZeroLossFn as JZero

    from apx_torch.core.losses import LambdaLossFn, WeightedLossFn, ZeroLossFn

    pred = np.ones((2, 3), dtype=np.float32)
    target = {"target": np.zeros((2, 3), dtype=np.float32),
              "weight": np.array([0.0, 1.0], dtype=np.float32)}
    w, jw = WeightedLossFn(inner=MSELossFn()), JWeighted(inner=JMSE())
    got = w(torch.from_numpy(pred), {k: torch.from_numpy(v) for k, v in target.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(jw(pred, target)))
    np.testing.assert_allclose(got.numpy(), [0.0, 1.0], rtol=1e-6)
    normed = WeightedLossFn(inner=MSELossFn(target_std=0.5).normalized, average_weight=0.25)
    assert normed.blind_guessing_expected_value == JWeighted(
        inner=JMSE(target_std=0.5).normalized, average_weight=0.25).blind_guessing_expected_value
    assert w.lower_bound == jw.lower_bound == 0.0
    z, jz = ZeroLossFn(), JZero()
    assert z((), ()).shape == np.asarray(jz((), ())).shape == ()
    out = z((), (), batch_shape=(5,))
    assert out.shape == (5,) and out.dtype == torch.float32 and not out.any()
    assert z.blind_guessing_expected_value == jz.blind_guessing_expected_value == 0.0
    lam = LambdaLossFn(fn=lambda p, t: (p - t).abs().sum(-1), lower_bound_value=0.0)
    assert torch.equal(lam(torch.ones(2, 3), torch.zeros(2, 3)), torch.full((2,), 3.0))
    assert lam.lower_bound == 0.0 and lam.blind_guessing_expected_value is None
    assert hash(lam) == hash(lam)


def test_mse_sum_forms():
    """MSELossFn's two sum forms: the contracted one (one FMA per further
    square) and the unfused one, which the jitted reference uses per env."""
    from apx_torch.core.numerics import sum_squares

    rng = np.random.default_rng(1)
    d = torch.from_numpy(rng.uniform(-1, 1, (4096, 2)).astype(np.float32))
    fused = MSELossFn()(d, torch.zeros_like(d))
    plain = MSELossFn(fused_sum=False)(d, torch.zeros_like(d))
    assert torch.equal(fused, sum_squares(d) / 2)
    assert torch.equal(plain, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) / 2)
    assert not torch.equal(fused, plain)


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "CircleSquare-v0"])
def test_envs_without_step_draws_consume_nothing(env_id):
    """LIDAR and CircleSquare draw nothing at step, so their generator
    streams, and every trajectory drawn from them, are as before."""
    venv, p = apx_torch.make_vec(env_id, 4, device="cpu")
    g = torch.Generator().manual_seed(3)
    before = g.get_state()
    assert venv.env.draw_step(4, p, g) == {} and venv.env.draw_step(4, p, None) == {}
    assert torch.equal(g.get_state(), before)


def test_vector_step_draws_step_draws_before_reset_draws():
    """Without injected draws a vector step takes its step draws, then its
    reset draws (apx's split order: step_key, reset_key); boundary_reset_step
    takes the same."""
    from apx_torch.core.env import VectorState

    venv, p = apx_torch.make_vec("LightDark-v0", 6, device="cpu")
    g = torch.Generator().manual_seed(4)
    obs, s, _ = venv.reset(p, g)
    s = VectorState(inner=s.inner, prev_done=torch.tensor([True, False] * 3))
    act = {"action": torch.rand((6, 2), generator=g), "prediction": torch.zeros(6, 2)}
    g2 = torch.Generator().manual_seed(9)
    sd = venv.env.draw_step(6, p, g2)
    rd = venv.env.draw_reset(6, p, g2)
    a = venv.step(s, act, p, torch.Generator().manual_seed(9))
    b = venv.step(s, act, p, reset_draws=rd, step_draws=sd)
    assert torch.equal(a[0]["noisy_position"], b[0]["noisy_position"])
    assert torch.equal(a[1].inner.inner.pos, b[1].inner.inner.pos) and torch.equal(a[2], b[2])
    lock = apx_torch.vector_env(venv.env, 6, apx_torch.AutoResetMode.LOCKSTEP)
    c = lock.boundary_reset_step(s, act, p, torch.Generator().manual_seed(9))
    d = lock.boundary_reset_step(s, act, p, reset_draws=rd)
    assert torch.equal(c[0]["noisy_position"], d[0]["noisy_position"])
    with pytest.raises(ValueError, match="Generator"):
        venv.step(s, act, p)


def test_with_autoreset_recurses_into_vector_wrappers():
    from apx_torch.core.env import AutoResetMode, with_autoreset

    venv, p = apx_torch.make_vec("CircleSquare-s15-v0", 2, device="cpu", metrics=True)
    inner = with_autoreset(venv, AutoResetMode.DISABLED)
    assert type(inner) is type(venv) and inner.autoreset is AutoResetMode.DISABLED
    assert inner.venv.autoreset is AutoResetMode.DISABLED and venv.autoreset is AutoResetMode.LOCKSTEP
    with pytest.raises(TypeError, match="autoreset"):
        with_autoreset(apx_torch.core.env.VectorState(inner=None, prev_done=None),
                       AutoResetMode.DISABLED)
