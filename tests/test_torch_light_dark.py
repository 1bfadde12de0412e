"""apx_torch's LightDark env against apx's, on the CPU.

apx draws from threefry keys; the tests compute the draws those keys give,
with the calls apx's ``VectorAPEnv.step`` and ``LightDarkEnv`` make, and
inject them into the port: a step's ``split(step_key, N)`` gives each
env's noise, and each reset key's ``split`` gives ``(k_pos, k_obs)``. The
noise is injected as ``erfinv(u)``, the N(0, 1/2) draw that XLA scales by
the folded constant ``sqrt(2) * 0.3`` (apx_torch.envs.light_dark).
Observations, states, rewards and dones are bitwise apx's jitted ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax import special as lax_special

import apx
from apx.compat.builders import reset_from_draws as jax_reset_from_draws
from apx.envs.light_dark import LightDarkEnv as JaxLightDark
from apx.envs.light_dark import LightDarkState as JaxState
from apx.envs.light_dark import brightness as jax_brightness
from apx.envs.light_dark import obs_std as jax_obs_std

import apx_torch
import apx_torch.envs.light_dark as ld
from apx_torch.compat.builders import reset_from_draws
from apx_torch.convert import light_dark_state_from_numpy
from apx_torch.core.numerics import fma, sum_squares
from apx_torch.envs.light_dark import LightDarkEnv, LightDarkState, brightness, obs_std

torch.set_num_threads(1)
N = 16
_LO = np.nextafter(np.float32(-1), np.float32(0))


def _erfinv_noise(key):
    """jax.random.normal's draw before its sqrt(2): erfinv(u), u in (-1, 1)."""
    return lax_special.erf_inv(jax.random.uniform(key, (2,), jnp.float32, _LO, 1.0))


def _reset_one(key):
    k_pos, k_obs = jax.random.split(key)
    return jax.random.uniform(k_pos, (2,), minval=-1.0, maxval=1.0), _erfinv_noise(k_obs)


_step_noise = jax.jit(jax.vmap(_erfinv_noise))
_reset_draws = jax.jit(jax.vmap(_reset_one))


def reset_draws(keys):
    pos, noise = _reset_draws(keys)
    return {"pos": torch.from_numpy(np.array(pos)), "noise": torch.from_numpy(np.array(noise))}


def step_draws(keys):
    return {"noise": torch.from_numpy(np.array(_step_noise(keys)))}


def vector_step_draws(key, n):
    """(step draws, reset draws) of apx's ``VectorAPEnv.step(key)``."""
    step_key, reset_key = jax.random.split(key)
    return step_draws(jax.random.split(step_key, n)), reset_draws(jax.random.split(reset_key, n))


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


def _params():
    return LightDarkEnv(device="cpu").default_params()


def test_brightness_formula():
    params = _params()
    at_light = torch.tensor([[0.0, -0.7]])
    np.testing.assert_allclose(brightness(at_light, params).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(obs_std(at_light, params).numpy(), 0.0, atol=1e-7)
    d2 = 1.0 + 1.7 ** 2 + 0.04
    np.testing.assert_allclose(brightness(torch.tensor([[1.0, 1.0]]), params).numpy(), 0.04 / d2,
                               rtol=1e-6)
    pos = np.random.default_rng(0).uniform(-1, 1, (512, 2)).astype(np.float32)
    jp = JaxLightDark().default_params()
    _eq(jax.jit(jax.vmap(lambda p: jax_brightness(p, jp)))(pos), brightness(torch.from_numpy(pos), params),
        "brightness")
    _eq(jax.jit(jax.vmap(lambda p: jax_obs_std(p, jp)))(pos), obs_std(torch.from_numpy(pos), params),
        "obs_std")


def test_step_semantics():
    """A big action is normalised to unit length and scaled by 0.15; the
    reward uses the raw action; the target is the position before."""
    env, params = LightDarkEnv(device="cpu"), _params()
    g = torch.Generator().manual_seed(0)
    obs, state, _ = env.reset(1, params, g)
    assert (state.pos.abs() <= 1).all() and obs["noisy_position"].shape == (1, 2)
    r = env.step_env(state, torch.tensor([[3.0, 4.0]]), torch.zeros(1, 2), params,
                     env.draw_step(1, params, g))
    np.testing.assert_allclose(r.base_reward.numpy(), 1.0 - 1e-3 * 25.0, rtol=1e-6)
    expected = np.clip(state.pos.numpy() + np.array([0.6, 0.8]) * 0.15, -1, 1)
    np.testing.assert_allclose(r.state.pos.numpy(), expected, atol=1e-6)
    assert torch.equal(r.prediction_target, state.pos)
    jr = JaxLightDark().step_env(jax.random.PRNGKey(0), JaxState(pos=jnp.asarray(state.pos[0])),
                                 jnp.array([3.0, 4.0]), jnp.zeros(2), JaxLightDark().default_params())
    np.testing.assert_allclose(np.asarray(jr.state.pos), r.state.pos[0].numpy(), atol=1e-7)


def test_termination_out_of_bounds():
    env, params = LightDarkEnv(device="cpu"), _params()
    state = LightDarkState(pos=torch.tensor([[0.95, 0.0], [0.0, 0.0]]))
    r = env.step_env(state, torch.tensor([[1.0, 0.0], [1.0, 0.0]]), torch.zeros(2, 2), params,
                     {"noise": torch.zeros(2, 2)})
    assert r.terminated.tolist() == [True, False]
    np.testing.assert_allclose(r.state.pos.numpy(), [[1.0, 0.0], [0.15, 0.0]], atol=1e-6)


def test_vectorized_rollout():
    """Envs walk out of bounds and reset per env; the obs stays clipped."""
    venv = apx_torch.vector_env(LightDarkEnv(device="cpu"), 64)
    params = _params()
    g = torch.Generator().manual_seed(1)
    obs, state, _ = venv.reset(params, g)
    act = {"action": torch.full((64, 2), 0.5), "prediction": torch.zeros(64, 2)}
    terms = 0
    for _ in range(40):
        obs, state, reward, term, trunc, _ = venv.step(state, act, params, g)
        terms += int(term.sum())
    assert terms > 0
    assert (obs["noisy_position"].abs() <= 2.0).all()


def test_native_draws():
    """The port's own draws: positions uniform in [-1, 1)^2, noise N(0, 1/2)."""
    venv, p = apx_torch.make_vec("LightDark-v0", 4096, device="cpu")
    g = torch.Generator().manual_seed(2)
    d = venv.env.draw_reset(4096, p, g)
    assert d["pos"].min() >= -1 and d["pos"].max() < 1 and abs(d["pos"].std() - 1 / 3 ** 0.5) < 0.02
    s = venv.env.draw_step(4096, p, g)["noise"]
    assert s.shape == (4096, 2) and abs(float(s.mean())) < 0.02
    assert abs(float(s.std()) - 0.5 ** 0.5) < 0.02
    with pytest.raises(ValueError, match="Generator"):
        venv.env.draw_step(4, p, None)


def _trajectory(steps, key_seed, n=N, action_scale=1.0):
    """apx's jitted LightDark-v0 and the port's, stepped side by side."""
    jvenv, jp = apx.make_vec("LightDark-v0", num_envs=n)
    venv, p = apx_torch.make_vec("LightDark-v0", n, device="cpu")
    key = jax.random.PRNGKey(key_seed)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    obs, s, _ = venv.reset(p, draws=reset_draws(jax.random.split(key, n)))
    yield "reset", (jobs, js, None, None, None), (obs, s, None, None, None)
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(key_seed)
    for t in range(steps):
        kt = jax.random.fold_in(key, t)
        act = (rng.uniform(-1, 1, (n, 2)) * action_scale).astype(np.float32)
        pred = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        jout = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(pred)}, jp)
        sd, rd = vector_step_draws(kt, n)
        out = venv.step(s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(pred)},
                        p, reset_draws=rd, step_draws=sd)
        js, s = jout[1], out[1]
        yield t, jout[:5], out[:5]


def test_trajectory_bitwise_equal_to_apx():
    ends = 0
    for t, (jobs, js, jr, jte, jtr), (obs, s, r, te, tr) in _trajectory(120, 11):
        what = f"step {t}"
        _eq(jobs["noisy_position"], obs["noisy_position"], f"{what} noisy_position")
        _eq(jobs["time_step"], obs["time_step"], f"{what} time_step")
        _eq(js.inner.inner.pos, s.inner.inner.pos, f"{what} pos")
        _eq(js.inner.t, s.inner.t, f"{what} t")
        _eq(js.prev_done, s.prev_done, f"{what} prev_done")
        if t != "reset":
            _eq(jr, r, f"{what} reward")
            _eq(jte, te, f"{what} terminated")
            _eq(jtr, tr, f"{what} truncated")
            ends += te.to(torch.int64)
    assert int(ends.min()) >= 2  # every env went through at least two episode ends


def test_state_carried_across_with_convert():
    """Start the port from apx's mid-episode state (convert) and step both."""
    jvenv, jp = apx.make_vec("LightDark-v0", num_envs=N)
    venv, p = apx_torch.make_vec("LightDark-v0", N, device="cpu")
    key = jax.random.PRNGKey(3)
    _, js, _ = jax.jit(jvenv.reset)(key, jp)
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(1)
    for t in range(50):
        act = {"action": jnp.asarray(rng.uniform(-1, 1, (N, 2)), jnp.float32),
               "prediction": jnp.zeros((N, 2))}
        _, js, *_ = step(jax.random.fold_in(key, t), js, act, jp)
    done = np.asarray(js.prev_done)
    assert done.any() and not done.all()  # some envs reset on the next step, some step
    s = light_dark_state_from_numpy(js.inner.inner.pos, js.inner.t, js.prev_done, device="cpu")
    act = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    pred = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    kt = jax.random.fold_in(key, 99)
    jobs, js2, jr, jte, *_ = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(pred)},
                                  jp)
    sd, rd = vector_step_draws(kt, N)
    obs, s2, r, te, *_ = venv.step(s, {"action": torch.from_numpy(act),
                                       "prediction": torch.from_numpy(pred)}, p,
                                   reset_draws=rd, step_draws=sd)
    for k in jobs:
        _eq(jobs[k], obs[k], f"obs {k}")
    _eq(js2.inner.inner.pos, s2.inner.inner.pos, "pos")
    _eq(jr, r, "reward")
    _eq(jte, te, "terminated")


def test_reset_from_host_draws_matches_apx_builder():
    """Host draws carry standard-normal noise, scaled by obs_std itself."""
    jvenv, jp = apx.make_vec("LightDark-v0", num_envs=8)
    venv, p = apx_torch.make_vec("LightDark-v0", 8, device="cpu")
    rng = np.random.default_rng(4)
    draws = {"pos": rng.uniform(-1, 1, (8, 2)).astype(np.float32),
             "noise": rng.standard_normal((8, 2)).astype(np.float32)}
    draws["pos"][0] = [0.0, -0.7]  # at the light: no noise
    jobs, js, _ = jax.jit(lambda d: jax_reset_from_draws(jvenv.env, d, jp))(draws)
    obs, s, info = reset_from_draws(venv.env, draws, p)
    for k in jobs:
        _eq(jobs[k], obs[k], f"obs {k}")
    _eq(js.inner.pos, s.inner.pos, "pos")
    _eq(js.t, s.t, "t")
    assert info == {}


@pytest.fixture(scope="module")
def apx_light_dark_steps():
    """40 steps of apx's jitted LightDark-v0 at N=64: each step's pre-step
    state, its outputs, the draws its key gives, the action and prediction."""
    n = 64
    jvenv, jp = apx.make_vec("LightDark-v0", num_envs=n)
    key = jax.random.PRNGKey(5)
    _, js, _ = jax.jit(jvenv.reset)(key, jp)
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(5)
    out = []
    for t in range(40):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        pred = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        o, js1, r, *_ = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(pred)}, jp)
        out.append((js, o, js1, r, vector_step_draws(kt, n), act, pred))
        js = js1
    return n, out


def _steps_differing(n, steps):
    """Steps (each from apx's own pre-step state) whose obs, position or
    reward differs from apx's."""
    venv, p = apx_torch.make_vec("LightDark-v0", n, device="cpu")
    bad = 0
    for js, jobs, js1, jr, (sd, rd), act, pred in steps:
        s = light_dark_state_from_numpy(js.inner.inner.pos, js.inner.t, js.prev_done, device="cpu")
        obs, s1, r, *_ = venv.step(s, {"action": torch.from_numpy(act),
                                       "prediction": torch.from_numpy(pred)}, p,
                                   reset_draws=rd, step_draws=sd)
        same = (np.array_equal(np.asarray(jobs["noisy_position"]), obs["noisy_position"].numpy())
                and np.array_equal(np.asarray(js1.inner.inner.pos), s1.inner.inner.pos.numpy())
                and np.array_equal(np.asarray(jr), r.numpy()))
        bad += not same
    return bad


def _brightness_unfused_sum(pos, params):
    d = pos - torch.tensor(params.light_pos)
    h2 = float(np.float32(params.light_height ** 2))
    dist = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + h2
    return torch.full_like(dist, h2) / dist


def _brightness_reciprocal(pos, params):
    h2 = float(np.float32(params.light_height ** 2))
    return h2 / (sum_squares(pos - torch.tensor(params.light_pos)) + h2)  # h2 * (1 / d)


def _noisy_unfused(pos, noise, scale, params):
    return (pos + noise * ((1.0 - brightness(pos, params)) * scale)[:, None]).clamp(-2, 2)


_noisy_position = ld.noisy_position


def _noisy_unfolded(pos, noise, scale, params):
    # N(0, 1) noise as sqrt(2) * erfinv(u), scaled by the noise scale apart.
    if scale != params.folded_noise_scale:
        return _noisy_position(pos, noise, scale, params)
    normal = noise * float(np.float32(np.sqrt(2)))
    return fma(normal, obs_std(pos, params)[:, None], pos).clamp(-2, 2)


def _reward_unfused(action):
    return 1.0 - 1e-3 * sum_squares(action)


def _move_unfused(pos, action, params):
    return pos + ld.normalize_into_unit_ball(action) * params.move_scale


def _move_unfused_norm(pos, action, params):
    mag = torch.sqrt((action[:, 0] * action[:, 0] + action[:, 1] * action[:, 1]).double()).float()
    move = torch.where((mag > 1)[:, None], action / mag[:, None], action)
    return fma(move, torch.full_like(move, params.move_scale), pos)


def _loss_fused(self, params):
    return ld.make_regression_loss_and_target_space(2, -1.0, 1.0)[0]


_SITES = {
    "brightness |p - light|^2 contracted -> unfused": ("brightness", _brightness_unfused_sum),
    "brightness h^2 / d -> h^2 * (1 / d)": ("brightness", _brightness_reciprocal),
    "noisy obs fma -> unfused": ("noisy_position", _noisy_unfused),
    "folded sqrt(2) * 0.3 -> sqrt(2) * erfinv(u), then * 0.3": ("noisy_position", _noisy_unfolded),
    "base reward fma(-1e-3, |a|^2, 1) -> 1 - 1e-3 |a|^2": ("base_reward", _reward_unfused),
    "move fma -> unfused": ("moved_position", _move_unfused),
    "|a| contracted -> unfused": ("moved_position", _move_unfused_norm),
    "loss squares unfused -> contracted": ("loss_fn", _loss_fused),
}


@pytest.mark.parametrize("site", ["as written", *_SITES])
def test_light_dark_rounding_sites(apx_light_dark_steps, monkeypatch, site):
    """The port's step equals apx's jitted step on every step; written any
    other way, each rounding site makes steps differ."""
    n, steps = apx_light_dark_steps
    if site == "as written":
        assert _steps_differing(n, steps) == 0
        return
    name, fn = _SITES[site]
    if name == "loss_fn":
        monkeypatch.setattr(LightDarkEnv, "loss_fn", fn)
    else:
        monkeypatch.setattr(ld, name, fn)
    assert _steps_differing(n, steps) > 0
