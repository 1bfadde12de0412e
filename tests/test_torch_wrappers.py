"""apx_torch's wrappers against apx's on the CPU: the ``-sparse`` ids
(Sparsify), the episode-metrics wrappers, the pseudo AP env with
TimeLimit's 1-D Box and tuple forms, VectorToSingle, and the registry's
46 ids.

Draws are computed from apx's keys and injected, as in the env tests
(``test_torch_lidar_env``, ``test_torch_image_env``,
``test_torch_light_dark``). LIDAR and LightDark outputs are bitwise apx's;
CircleSquare rewards are held to 1e-6 (log-softmax), and the float stats
to 1e-6 (softmax, and sums over the ring); int and bool stats and the NaN
positions are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct
from test_torch_image_env import _draw_fn as image_draw_fn
from test_torch_lidar_env import _draw_fn as lidar_draw_fn
from test_torch_light_dark import reset_draws as light_dark_reset_draws
from test_torch_light_dark import vector_step_draws as light_dark_step_draws

import apx
from apx.core.env import AutoResetMode as JaxMode
from apx.core.env import vmap_vector_env as jax_vector_env
from apx.core.spaces import Box as JaxBox
from apx.core.spaces import TupleSpace as JaxTuple
from apx.wrappers.pseudo import PseudoActivePerceptionEnv as JaxPseudo
from apx.wrappers.time_limit import TimeLimit as JaxTimeLimit

import apx_torch
from apx_torch.convert import image_state_from_numpy, metrics_state_from_numpy
from apx_torch.core.env import AutoResetMode, rollout, rollout_episodic, tree_map
from apx_torch.core.spaces import Box, TupleSpace
from apx_torch.wrappers import (ClassificationMetrics, PseudoActivePerceptionEnv, Sparsify,
                                TimeLimit, VectorToSingle)

torch.set_num_threads(1)
TOL = 1e-6


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    if a.dtype.kind in "iu":
        a, b = a.astype(np.int64), b.astype(np.int64)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _close(a, b, what, tol=TOL):
    a = np.asarray(a, dtype=np.float64)
    b = b.numpy().astype(np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what}: NaN positions")
    ok = ~np.isnan(a)
    err = np.abs(a[ok] - b[ok]).max(initial=0.0)
    assert err <= tol, f"{what}: max |diff| {err}"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _check_stats(jstats, stats, what):
    """ints, bools and NaN positions bitwise, floats within TOL."""
    jflat, flat = _flat(jstats), _flat(stats)
    assert set(jflat) == set(flat), what
    for k, v in jflat.items():
        if np.asarray(v).dtype.kind == "f":
            _close(v, flat[k], f"{what} stats {k}")
        else:
            _eq(v, flat[k], f"{what} stats {k}")


# ---------------------------------------------------------------------------
# Side-by-side trajectories of apx (jitted) and the port.


def _draws(env_id, jp, n):
    """kt -> (step draws, reset draws) of apx's VectorAPEnv.step(kt), and
    keys -> the reset draws of apx's VectorAPEnv.reset."""
    if env_id.startswith("LightDark"):
        return (lambda kt: light_dark_step_draws(kt, n)), light_dark_reset_draws
    fn = lidar_draw_fn(jp) if env_id.startswith("LIDAR") else image_draw_fn(jp)
    return (lambda kt: ({}, fn(jax.random.split(jax.random.split(kt)[1], n)))), fn


def _side_by_side(env_id, n, steps, seed, metrics=False, logits=False, **overrides):
    """Yield (t, apx step outputs, port step outputs) for ``steps`` steps
    of uniform actions in [-1, 1] and uniform (or normal logit)
    predictions, from the same keys' draws."""
    jvenv, jp = apx.make_vec(env_id, num_envs=n, metrics=metrics, **overrides)
    venv, p = apx_torch.make_vec(env_id, n, device="cpu", metrics=metrics, **overrides)
    step_draws, reset_draws = _draws(env_id, jp, n)
    key = jax.random.PRNGKey(seed)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    obs, s, _ = venv.reset(p, draws=reset_draws(jax.random.split(key, n)))
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(seed)
    for t in range(steps):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        pred = (rng.standard_normal((n, 2)) if logits else rng.uniform(-1, 1, (n, 2)))
        pred = pred.astype(np.float32)
        jout = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(pred)}, jp)
        sd, rd = step_draws(kt)
        out = venv.step(s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(pred)},
                        p, reset_draws=rd, step_draws=sd)
        js, s = jout[1], out[1]
        yield t, jout, out


def _check_prediction_info(jinfo, info, what, loss_tol=0.0):
    """The {"target", "weight"} target, and the dense loss (apx's quirk)."""
    jt, t = jinfo["prediction"]["target"], info["prediction"]["target"]
    assert set(t) == {"target", "weight"}, what
    _eq(jt["target"], t["target"], f"{what} target")
    _eq(jt["weight"], t["weight"], f"{what} weight")
    if loss_tol:
        _close(jinfo["prediction"]["loss"], info["prediction"]["loss"], f"{what} loss", loss_tol)
    else:
        _eq(jinfo["prediction"]["loss"], info["prediction"]["loss"], f"{what} dense loss")
    _eq(jinfo["base_reward"], info["base_reward"], f"{what} base_reward")


def test_lidar_sparse_trajectory_bitwise_equal_to_apx():
    """LIDARLocRooms-sparse-v0, 250 steps: obs, states, rewards, dones and
    the prediction info bitwise; the weight is terminated, and the reward
    is base_reward - weight * dense loss. (On an autoreset step the weight
    is the masked-out step's, as in apx, and the reward 0.)"""
    n, ends, prev_done = 16, 0, torch.zeros(16, dtype=torch.bool)
    for t, (jobs, js, jr, jte, jtr, jinfo), (obs, s, r, te, tr, info) in _side_by_side(
            "LIDARLocRooms-sparse-v0", n, 250, 11):
        what = f"step {t}"
        for k in jobs:
            _eq(jobs[k], obs[k], f"{what} obs {k}")
        _eq(js.inner.inner.pos, s.inner.inner.pos, f"{what} pos")
        _eq(js.inner.t, s.inner.t, f"{what} t")
        _eq(jr, r, f"{what} reward")
        _eq(jte, te, f"{what} terminated")
        _eq(jtr, tr, f"{what} truncated")
        _check_prediction_info(jinfo, info, what)
        weight = info["prediction"]["target"]["weight"]
        live = prev_done.logical_not()
        assert torch.equal(weight[live], te[live].to(torch.float32)), what
        off = (weight == 0) | prev_done
        assert torch.equal(r[off], info["base_reward"][off]), what
        ends += int(te.sum())
        prev_done = s.prev_done
    assert ends >= 2 * n


def test_circle_square_sparse_trajectory_matches_apx():
    """CircleSquare-s15-sparse-v0, three LOCKSTEP cycles."""
    n, resets = 16, 0
    for t, (jobs, js, jr, jte, jtr, jinfo), (obs, s, r, te, tr, info) in _side_by_side(
            "CircleSquare-s15-sparse-v0", n, 51, 5, logits=True):
        what = f"step {t}"
        for k in jobs:
            (_close if k == "glimpse" else _eq)(jobs[k], obs[k], f"{what} obs {k}")
        _eq(js.inner.pos, s.inner.pos, f"{what} pos")
        _eq(js.inner.time, s.inner.time, f"{what} time")
        _eq(jte, te, f"{what} terminated")
        _close(jr, r, f"{what} reward")
        _check_prediction_info(jinfo, info, what, loss_tol=TOL)
        weight = info["prediction"]["target"]["weight"]
        assert torch.equal(weight, te.to(torch.float32)), what
        if not te.any():
            assert torch.equal(r, info["base_reward"]), what
        resets += int((s.inner.time == 0).all())
    assert resets == 3


def test_sparse_variant_reward_gating():
    """apx's tests/test_registry.py:154-170 on the port: zero actions and
    logits give reward 0 until the terminal step, where the normalised CE
    of zero logits (1) counts."""
    venv, p = apx_torch.make_vec("CircleSquare-s15-sparse-v0", 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    obs, s, _ = venv.reset(p, g)
    act = {"action": torch.zeros(4, 2), "prediction": torch.zeros(4, 2)}
    for _ in range(16):
        obs, s, r, te, tr, info = venv.step(s, act, p, g)
        done = te | tr
        assert torch.equal(info["prediction"]["target"]["weight"], done.to(torch.float32))
        if not done.any():
            assert torch.equal(r, torch.zeros(4))
    assert done.all()
    np.testing.assert_allclose(r.numpy(), -1.0, atol=1e-5)
    # The LOCKSTEP reset step: weight 0, the dense loss still reported.
    obs, s, r, te, tr, info = venv.step(s, act, p, g)
    assert torch.equal(info["prediction"]["target"]["weight"], torch.zeros(4))
    assert torch.equal(r, torch.zeros(4))
    np.testing.assert_allclose(info["prediction"]["loss"].numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("env_id,steps,logits", [
    ("CircleSquare-s15-v0", 40, True),
    ("CircleSquareInverted-s15-sparse-v0", 40, True),
    ("LightDark-v0", 120, False),
    ("LIDARLocRoomsStatic-sparse-v0", 210, False),
])
def test_metrics_match_apx(env_id, steps, logits):
    """info["stats"] and the metrics state against apx's over at least two
    episodes of every env."""
    n, dones = 8, 0
    for t, (jobs, js, jr, jte, jtr, jinfo), (obs, s, r, te, tr, info) in _side_by_side(
            env_id, n, steps, 7, metrics=True, logits=logits):
        what = f"{env_id} step {t}"
        _check_stats(jinfo["stats"], info["stats"], what)
        _eq(js.count, s.count, f"{what} count")
        _eq(js.prev_done, s.prev_done, f"{what} prev_done")
        for k in js.buf:
            _close(js.buf[k], s.buf[k], f"{what} buf {k}")
        (_close if logits else _eq)(jr, r, f"{what} reward")
        dones += (te | tr).to(torch.int64)
    assert int(dones.min()) >= 2


def test_metrics_invariants():
    """apx's tests/test_registry.py:56-101 on the port: zero logits give a
    correct-label probability of 0.5 and accuracy 0, episodes of exactly 16
    recorded steps; LightDark's regression stats are finite exactly where
    done."""
    venv, p = apx_torch.make_vec("CircleSquare-s15-v0", 4, device="cpu", metrics=True)
    g = torch.Generator().manual_seed(0)
    obs, s, _ = venv.reset(p, g)
    act = {"action": torch.zeros(4, 2), "prediction": torch.zeros(4, 2)}
    seen = 0
    for _ in range(35):
        obs, s, r, te, tr, info = venv.step(s, act, p, g)
        stats, done = info["stats"]["scalar"], te | tr
        assert torch.equal(stats["_final_correct_label_prob"], done)
        if done.any():
            seen += 1
            np.testing.assert_allclose(stats["avg_correct_label_prob"][done].numpy(), 0.5, atol=1e-6)
            assert (stats["avg_accuracy"][done] == 0).all()
            assert (stats["first_correct"][done] == -1).all() and not stats["_first_correct"].any()
            assert stats["_last_incorrect"][done].all()
            assert (info["stats"]["vector_lengths"][done] == 16).all()
    assert seen == 2
    venv, p = apx_torch.make_vec("LightDark-v0", 4, device="cpu", metrics=True)
    obs, s, _ = venv.reset(p, g)
    for _ in range(60):
        obs, s, r, te, tr, info = venv.step(s, act, p, g)
        done = te | tr
        for k in ("avg_mse", "final_euclidean_distance", "avg_euclidean_distance", "final_mse"):
            assert torch.equal(torch.isfinite(info["stats"]["scalar"][k]), done), k


def test_metrics_state_carried_across_with_convert():
    """Start the port from apx's mid-episode metrics state (convert)."""
    n = 8
    jvenv, jp = apx.make_vec("CircleSquare-s15-v0", num_envs=n, metrics=True)
    venv, p = apx_torch.make_vec("CircleSquare-s15-v0", n, device="cpu", metrics=True)
    key = jax.random.PRNGKey(2)
    _, js, _ = jax.jit(jvenv.reset)(key, jp)
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(2)
    for t in range(20):
        act = {"action": jnp.asarray(rng.uniform(-1, 1, (n, 2)), jnp.float32),
               "prediction": jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)}
        _, js, *_ = step(jax.random.fold_in(key, t), js, act, jp)
    i = js.inner.inner
    inner = image_state_from_numpy(i.image, i.label, i.data_index, i.pos, i.time,
                                   i.label_inverted, js.inner.prev_done, device="cpu")
    s = metrics_state_from_numpy(inner, js.buf, js.count, js.prev_done, device="cpu")
    act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    logits = rng.standard_normal((n, 2)).astype(np.float32)
    kt = jax.random.fold_in(key, 99)
    *_, jinfo = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(logits)}, jp)
    *_, info = venv.step(s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(logits)},
                         p, reset_draws=image_draw_fn(jp)(jax.random.split(jax.random.split(kt)[1], n)))
    _check_stats(jinfo["stats"], info["stats"], "convert")


def test_metrics_episodic_rollout_equals_masked_merge():
    """apx's tests/test_registry.py:219: metrics-wrapped CircleSquare rides
    the episodic rollout (with_autoreset recurses into the wrapper) with
    the masked-merge loop's trajectory and state, bitwise."""
    venv, p = apx_torch.make_vec("CircleSquare-s15-v0", 6, device="cpu", metrics=True)
    assert isinstance(venv, ClassificationMetrics)

    def policy(gen, obs):
        return {"action": torch.rand((6, 2), generator=gen) * 2 - 1,
                "prediction": torch.randn((6, 2), generator=gen)}

    steps = 2 * (p.step_limit + 1) + 2
    outs = [fn(venv, p, policy, torch.Generator().manual_seed(37), steps, *extra)
            for fn, extra in ((rollout, ()), (rollout_episodic, (p.step_limit,)))]
    (obs_a, s_a, traj_a), (obs_b, s_b, traj_b) = outs
    leaves_a, leaves_b = [], []
    tree_map(leaves_a.append, (obs_a, s_a, traj_a))
    tree_map(leaves_b.append, (obs_b, s_b, traj_b))
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert torch.equal(a, b)


def test_light_dark_episodic_rollout_with_step_draws():
    """rollout_episodic draws step and reset draws as venv.step does: on a
    LOCKSTEP LightDark (step draws every step) it equals rollout."""
    env, p = apx_torch.make("LightDark-v0", device="cpu")
    venv = apx_torch.vector_env(env, 5, AutoResetMode.LOCKSTEP)

    def policy(gen, obs):
        return {"action": torch.zeros(5, 2), "prediction": torch.zeros(5, 2)}

    # Zero actions never leave the box: every episode lasts the 50-step limit.
    a = rollout(venv, p, policy, torch.Generator().manual_seed(3), 110)
    b = rollout_episodic(venv, p, policy, torch.Generator().manual_seed(3), 110, 50)
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)
    assert torch.equal(a[0]["noisy_position"], b[0]["noisy_position"])


# ---------------------------------------------------------------------------
# Pseudo AP env over plain envs: TimeLimit's 1-D Box and tuple forms.


class JaxPlainState(struct.PyTreeNode):
    x: jax.Array


class JaxPlainEnv:
    """apx's plain env of tests/test_aux.py:98-118, with a tuple-obs switch
    and random starts."""

    def __init__(self, tuple_obs=False):
        self.tuple_obs = tuple_obs

    def default_params(self, **kw):
        return ()

    def observation_space(self, params):
        box = JaxBox(low=-1.0, high=1.0, shape=(1,))
        return JaxTuple((box, box)) if self.tuple_obs else box

    def action_space(self, params):
        return JaxBox(low=-1.0, high=1.0, shape=(1,))

    def _obs(self, s):
        return (s.x, -s.x) if self.tuple_obs else s.x

    def reset_env(self, key, params):
        s = JaxPlainState(x=jax.random.uniform(key, (1,), minval=-0.5, maxval=0.5))
        return self._obs(s), s, {}

    def plain_step(self, key, state, action, params):
        s = JaxPlainState(x=jnp.clip(state.x + action, -1, 1))
        term = jnp.any(jnp.abs(s.x) >= 1.0)
        return self._obs(s), s, 1.0, term, jnp.zeros((), bool), {}


class PlainEnv:
    """The same plain env, batched, for the port's pseudo wrapper."""

    def __init__(self, tuple_obs=False):
        self.tuple_obs = tuple_obs

    def default_params(self, **kw):
        return ()

    def observation_space(self, params):
        box = Box(low=-1.0, high=1.0, shape=(1,))
        return TupleSpace((box, box)) if self.tuple_obs else box

    def action_space(self, params):
        return Box(low=-1.0, high=1.0, shape=(1,))

    def _obs(self, x):
        return (x, -x) if self.tuple_obs else x

    def draw_reset(self, num_envs, params, generator):
        return {"x": torch.rand((num_envs, 1), generator=generator) - 0.5}

    def reset_from_draws(self, draws, params):
        return self._obs(draws["x"]), draws["x"], {}

    def plain_step(self, state, action, params, draws):
        x = (state + action).clamp(-1, 1)
        return self._obs(x), x, 1.0, (x.abs() >= 1.0).any(dim=-1), torch.zeros_like(x[:, 0], dtype=bool), {}


@pytest.mark.parametrize("tuple_obs", [False, True])
def test_pseudo_env_with_time_limit_matches_apx(tuple_obs):
    """apx's tests/test_aux.py:91-134 on the port, under TimeLimit: a 1-D
    Box obs gains the time as one more column, a tuple obs as one more
    element; rewards are the base reward (ZeroLossFn), targets ()."""
    n, limit = 6, 7
    jenv = JaxTimeLimit(JaxPseudo(JaxPlainEnv(tuple_obs)), limit, issue_termination=True)
    env = TimeLimit(PseudoActivePerceptionEnv(PlainEnv(tuple_obs)), limit, issue_termination=True)
    jp, p = jenv.default_params(), env.default_params()
    assert env.prediction_space(p).spaces == () and env.prediction_target_space(p).spaces == ()
    jspace, space = jenv.observation_space(jp), env.observation_space(p)
    if tuple_obs:
        assert isinstance(space, TupleSpace) and len(space.spaces) == 3
        assert space.spaces[-1].shape == () and (space.spaces[-1].low, space.spaces[-1].high) == (-1, 1)
    else:
        assert space.shape == tuple(jspace.shape) == (2,)
        np.testing.assert_array_equal(space.low_arr, np.asarray(jspace.low_arr))
        np.testing.assert_array_equal(space.high_arr, np.asarray(jspace.high_arr))
    jvenv = jax_vector_env(jenv, n, JaxMode.NEXT_STEP)
    venv = apx_torch.vector_env(env, n)
    key = jax.random.PRNGKey(4)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    start = jax.vmap(lambda k: jax.random.uniform(k, (1,), minval=-0.5, maxval=0.5))

    def draws(k):
        return {"x": torch.from_numpy(np.array(start(jax.random.split(k, n))))}

    obs, s, _ = venv.reset(p, draws=draws(key))
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(4)
    for t in range(20):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-0.4, 0.4, (n, 1)).astype(np.float32)
        jobs, js, jr, jte, jtr, jinfo = step(kt, js, {"action": jnp.asarray(act), "prediction": ()}, jp)
        obs, s, r, te, tr, info = venv.step(
            s, {"action": torch.from_numpy(act), "prediction": ()}, p,
            reset_draws=draws(jax.random.split(kt)[1]))
        what = f"step {t}"
        if tuple_obs:
            assert isinstance(obs, tuple) and len(obs) == 3
            for a, b in zip(jobs, obs):
                _eq(a, b, f"{what} obs")
        else:
            assert obs.shape == (n, 2)
            _eq(jobs, obs, f"{what} obs")
        _eq(jr, r, f"{what} reward")
        _eq(jte, te, f"{what} terminated")
        _eq(js.inner.t, s.inner.t, f"{what} t")
        assert info["prediction"]["target"] == ()


def test_zero_loss_pseudo_step():
    env = PseudoActivePerceptionEnv(PlainEnv())
    p = env.default_params()
    obs, s, _ = env.reset(3, p, torch.Generator().manual_seed(0))
    obs, s, r, te, tr, info = env.step(s, {"action": torch.full((3, 1), 0.5), "prediction": ()}, p)
    assert torch.equal(r, torch.ones(3)) and info["prediction"]["target"] == ()


# ---------------------------------------------------------------------------
# VectorToSingle and the registry.


def test_vector_to_single_over_light_dark():
    """A 1-env LightDark-v0 run as a single env equals the vector env's
    batch of one, from the same generator."""
    vec, p = apx_torch.make_vec("LightDark-v0", 1, device="cpu")
    single = VectorToSingle(vec)
    assert single.env is vec.env and single.prediction_space(p).shape == (2,)
    with pytest.raises(ValueError, match="num_envs == 1"):
        VectorToSingle(apx_torch.make_vec("LightDark-v0", 2, device="cpu")[0])
    ga, gb = torch.Generator().manual_seed(6), torch.Generator().manual_seed(6)
    obs_a, s_a, _ = single.reset(p, ga)
    obs_b, s_b, _ = vec.reset(p, gb)
    assert obs_a["noisy_position"].shape == (2,) and obs_a["time_step"].shape == ()
    for t in range(60):
        a = torch.tensor([0.3, -0.2 + 0.01 * t])
        obs_a, s_a, r_a, te_a, tr_a, info_a = single.step(s_a, {"action": a, "prediction": a}, p, ga)
        obs_b, s_b, r_b, te_b, tr_b, _ = vec.step(s_b, {"action": a[None], "prediction": a[None]},
                                                  p, gb)
        assert r_a.shape == () and te_a.shape == ()
        assert torch.equal(r_a, r_b[0]) and torch.equal(te_a, te_b[0])
        assert torch.equal(obs_a["noisy_position"], obs_b["noisy_position"][0])
        assert info_a["prediction"]["target"].shape == (2,)
    # Injected draws are unsqueezed for the vector env.
    d = {"pos": torch.tensor([0.5, 0.5]), "noise": torch.zeros(2)}
    obs, s, _ = single.reset(p, draws=d)
    assert torch.equal(obs["noisy_position"], torch.tensor([0.5, 0.5]))


# The base ids of slices 1-6.
PORTED_BASE = (["LightDark-v0", "LIDARLocMazeStatic-v0", "LIDARLocMaze-v0",
                "LIDARLocRoomsStatic-v0", "LIDARLocRooms-v0"]
               + [f"{name}{sfx}-v0"
                  for sfx in ("", "-s28", "-s20", "-s15", "-nograd", "-s20-nograd",
                              "-s15-nograd", "-t32", "-t64")
                  for name in ("CircleSquare", "CircleSquareInverted")])


def test_env_ids_are_the_ported_subset_of_apx():
    """Since slice 7 the port has every id of apx (the wrapper tests below
    run the 46 ids of slices 1-6); an unknown id raises KeyError."""
    sparse = [i.rsplit("-", 1)[0] + "-sparse-v0" for i in PORTED_BASE]
    assert set(PORTED_BASE + sparse) <= set(apx_torch.env_ids())
    assert apx_torch.env_ids() == apx.env_ids() and len(apx_torch.env_ids()) == 158
    for env_id in ("DoubleCircleSquare-v1", "MNIST-sparse-v1", "CircleSquareHideAndSeek"):
        with pytest.raises(KeyError, match="Unknown env id"):
            apx_torch.make_vec(env_id, 2, device="cpu")


@pytest.mark.parametrize("env_id", sorted(
    PORTED_BASE + [i.rsplit("-", 1)[0] + "-sparse-v0" for i in PORTED_BASE]))
def test_every_id_samples_and_steps_with_metrics(env_id):
    """For each of the 46 ids: ``action_space(params).sample(g)`` (Logit
    predictions are unbounded), the id's kind of metrics wrapper and
    sparse wrapper, two steps with sampled actions."""
    n = 2
    venv, p = apx_torch.make_vec(env_id, n, device="cpu", metrics=True)
    jvenv, _ = apx.make_vec(env_id, num_envs=n, metrics=True)
    assert type(venv).__name__ == type(jvenv).__name__
    assert isinstance(venv.env, Sparsify) == env_id.endswith("-sparse-v0")
    g = torch.Generator().manual_seed(0)
    space = venv.env.action_space(p)
    one = space.sample(g)
    assert one["action"].shape == (2,) and space.inner_action_space.contains(one["action"])
    assert torch.isfinite(one["prediction"]).all()
    obs, s, _ = venv.reset(p, g)
    for _ in range(2):
        act = space.sample(g, (n,))
        obs, s, r, te, tr, info = venv.step(s, act, p, g)
    assert r.shape == (n,) and torch.isfinite(r).all()
    assert set(info["stats"]) == {"scalar", "_scalar", "vector", "_vector", "vector_lengths"}
