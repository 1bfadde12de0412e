"""The port's slice as a whole: apx_torch's LIDAR envs against apx's
default ("auto") envs, stepped with the same actions and the same reset
draws, bitwise in observations, states and dones.

apx draws resets from threefry keys; the test computes the draws those
keys give, with the calls apx's ``VectorAPEnv.step`` and
``LIDARLocalizationEnv.reset_env`` make, and injects them into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apx
from apx.compat.builders import reset_from_draws as jax_reset_from_draws

import apx_torch
from apx_torch.compat.builders import reset_from_draws
from apx_torch.convert import lidar_state_from_numpy

torch.set_num_threads(1)
N = 16


def _draw_fn(params):
    """keys -> the (bank_pos, k) draws apx's reset_env makes from each key."""
    bank = params.map_bank

    def one(key):
        k_map, k_cell = jax.random.split(key)
        if params.static_map:
            bank_pos = jnp.full((), params.static_map_pos, dtype=jnp.int32)
        else:
            bank_pos = jax.random.randint(k_map, (), 0, bank.num_maps, dtype=jnp.int32)
        n_free = jnp.take(bank.free_counts, bank_pos)
        return bank_pos, jax.random.randint(k_cell, (), 0, n_free, dtype=jnp.int32)

    batched = jax.jit(jax.vmap(one))

    def draws(keys):
        bank_pos, k = batched(keys)
        return {"bank_pos": torch.from_numpy(np.asarray(bank_pos).astype(np.int64)),
                "k": torch.from_numpy(np.asarray(k).astype(np.int64))}

    return draws


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


def _within_one_ulp(a, b, what):
    a = np.asarray(a)
    assert np.all(np.abs(a.astype(np.float64) - b.numpy()) <= np.spacing(np.abs(a))), what


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMazeStatic-v0"])
def test_trajectory_bitwise_equal_to_apx(env_id):
    jvenv, jp = apx.make_vec(env_id, num_envs=N)
    venv, p = apx_torch.make_vec(env_id, N, device="cpu")
    key = jax.random.PRNGKey(11)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    draws = _draw_fn(jp)
    obs, s, _ = venv.reset(p, draws=draws(jax.random.split(key, N)))
    for k in jobs:
        _eq(jobs[k], obs[k], f"reset {k}")
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(0)
    ends = 0
    for t in range(250):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
        pred = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
        jobs, js, jr, jte, jtr, _ = step(
            kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(pred)}, jp)
        _, reset_key = jax.random.split(kt)  # apx's VectorAPEnv.step split
        obs, s, r, te, tr, _ = venv.step(
            s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(pred)}, p,
            reset_draws=draws(jax.random.split(reset_key, N)))
        what = f"{env_id} step {t}"
        for k in ("lidar", "odometry", "time_step") + (("map",) if "map" in jobs else ()):
            _eq(jobs[k], obs[k], f"{what} obs {k}")
        ji, ti = js.inner.inner, s.inner.inner
        _eq(ji.pos, ti.pos, f"{what} pos")
        _eq(ji.initial_pos, ti.initial_pos, f"{what} initial_pos")
        _eq(np.asarray(ji.map_idx).astype(np.int64), ti.map_idx, f"{what} map_idx")
        _eq(js.inner.t, s.inner.t, f"{what} t")
        _eq(jte, te, f"{what} terminated")
        _eq(jtr, tr, f"{what} truncated")
        _within_one_ulp(jr, r, f"{what} reward")
        ends += int(te.sum())
    assert ends >= 2 * N  # every env went through at least two episodes


def test_state_carried_across_with_convert():
    """Start the port from apx's mid-episode state (convert) and step both."""
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=N)
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", N, device="cpu")
    key = jax.random.PRNGKey(3)
    _, js, _ = jax.jit(jvenv.reset)(key, jp)
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(1)
    for t in range(5):
        act = {"action": jnp.asarray(rng.uniform(-1, 1, (N, 2)), jnp.float32),
               "prediction": jnp.zeros((N, 2))}
        _, js, *_ = step(jax.random.fold_in(key, t), js, act, jp)
    i = js.inner.inner
    s = lidar_state_from_numpy(i.occ, i.pos, i.initial_pos, i.odo_pending, i.bank_pos,
                               i.map_idx, js.inner.t, js.prev_done, device="cpu")
    act = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    kt = jax.random.fold_in(key, 99)
    jobs, js2, jr, *_ = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.zeros((N, 2))}, jp)
    obs, s2, r, *_ = venv.step(
        s, {"action": torch.from_numpy(act), "prediction": torch.zeros(N, 2)}, p,
        reset_draws=_draw_fn(jp)(jax.random.split(jax.random.split(kt)[1], N)))
    for k in jobs:
        _eq(jobs[k], obs[k], f"obs {k}")
    _eq(js2.inner.inner.pos, s2.inner.inner.pos, "pos")
    _within_one_ulp(jr, r, "reward")


def test_reset_from_host_draws_matches_apx_builder():
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=4)
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", 4, device="cpu")
    maps = np.asarray(jp.map_bank.maps)[[0, 5, 9, 5]]
    rng = np.random.default_rng(2)
    pos = np.stack([np.stack(np.nonzero(~m)[::-1], -1)[rng.integers((~m).sum())] for m in maps])
    draws = {"occ": maps, "pos": (pos + 0.5).astype(np.float32),
             "map_idx": np.array([7, 8, 9, 10], np.uint32)}
    # Jitted, as the env runs it (eager JAX rounds the cast's pull-back
    # unfused; see test_torch_raycast).
    jobs, js, jinfo = jax.jit(lambda d: jax_reset_from_draws(jvenv.env, d, jp))(draws)
    obs, s, info = reset_from_draws(venv.env, draws, p)
    for k in jobs:
        _eq(jobs[k], obs[k], f"obs {k}")
    _eq(js.inner.pos, s.inner.pos, "pos")
    _eq(js.t, s.t, "t")
    _eq(np.asarray(jinfo["map_idx"]).astype(np.int64), info["map_idx"], "map_idx")


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMazeStatic-v0"])
def test_native_draws_in_range(env_id):
    """Without injected draws the port draws from its own generator: bank
    positions in [0, M) (or the static map), spawns on free cell centres."""
    venv, p = apx_torch.make_vec(env_id, 512, device="cpu")
    bank = p.map_bank
    g = torch.Generator().manual_seed(5)
    for _ in range(20):
        d = venv.env.draw_reset(512, p, g)
        assert d["bank_pos"].min() >= 0 and d["bank_pos"].max() < bank.num_maps
        assert (d["k"] >= 0).all() and (d["k"] < bank.free_counts[d["bank_pos"]]).all()
    if p.static_map:
        assert (d["bank_pos"] == p.static_map_pos).all()
    else:
        counts = torch.bincount(d["bank_pos"], minlength=bank.num_maps)
        assert (counts > 0).sum() > bank.num_maps // 2  # spread over the bank
    venv = apx_torch.vector_env(venv.env, 64)
    obs, s, _ = venv.reset(p, g)
    pos = s.inner.inner.pos
    assert torch.equal(pos - 0.5, torch.floor(pos))  # cell centres
    cx, cy = pos[:, 0].long(), pos[:, 1].long()
    assert not s.inner.inner.occ[torch.arange(64), cy, cx].any()  # on free cells
    act = {"action": torch.zeros(64, 2), "prediction": torch.zeros(64, 2)}
    for _ in range(101):
        obs, s, r, te, tr, _ = venv.step(s, act, p, g)
    assert not (te | tr).any() and (s.inner.t == 0).all()  # autoreset after the limit


def test_unported_options_raise():
    """Every apx option the port once refused is accepted and resolves as
    apx resolves it; an unknown value raises apx's ValueError where apx
    has one, and the port's where apx takes any string."""
    for backend in ("bitslab2d", "bitslab", "windowed", "hybrid", "mxu_window", "pallas", "xla",
                    "pallas_window"):
        _, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=2, raycast_backend=backend)
        _, p = apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu", raycast_backend=backend)
        for prop in ("use_bitslab2d", "use_bitslab", "use_mxu_window", "use_pallas_window",
                     "needs_row_halves", "windowed", "ray_pad"):
            assert getattr(p, prop) == getattr(jp, prop), (backend, prop)
    # apx's "auto" resolves to bitslab2d; the port's to the dense casts,
    # which are bitwise the same (test_trajectory_bitwise_equal_to_apx).
    _, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=2)
    _, p = apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu")
    assert jp.use_bitslab2d and not p.use_bitslab2d and not p.needs_row_halves
    with pytest.raises(ValueError, match="raycast_backend"):
        apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu", raycast_backend="dda")
    _, p = apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu", use_beam_tables=True)
    assert not p.beam_tables_active  # apx's rule: only on a bank with tables
    bank = p.map_bank.with_beam_tables()
    _, p = apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu", use_beam_tables=True,
                              map_bank=bank)
    assert p.beam_tables_active and bank.beam_face.shape == (256, 8, 2, 32, 32)
    _, p = apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu", raycast_backend="bitslab2d",
                              beam_rects="on")
    assert p.beam_rects_on is not None and len(p.beam_rects_on) == 8
    with pytest.raises(ValueError, match="beam_rects"):
        apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu", beam_rects="yes")
    for storage in ("packed", "flat", "gather", "array", "auto"):
        _, p = apx_torch.make_vec("MNIST-v0", 2, device="cpu", image_storage=storage)
        _, jp = apx.make_vec("MNIST-v0", num_envs=2, image_storage=storage)
        assert apx_torch.envs.image_perception.ImagePerceptionEngine.storage(p) == \
            apx.envs.image_perception.ImagePerceptionEngine.storage(jp)
    with pytest.raises(ValueError, match="int32-packed"):  # a float bank, as in apx
        apx_torch.make_vec("CircleSquare-v0", 2, device="cpu", image_storage="packed")
    with pytest.raises(ValueError, match="image_storage"):
        apx_torch.make_vec("CircleSquare-v0", 2, device="cpu", image_storage="tiled")
    _, p = apx_torch.make_vec("CircleSquare-v0", 2, device="cpu", glimpse_window="rows")
    assert apx_torch.envs.image_perception.ImagePerceptionEngine.resolved_glimpse_window(p) == \
        "rows"
    for backend in ("chunked", "streamed"):
        apx_torch.make_vec("CircleSquare-v0", 2, device="cpu", unique_sampling_backend=backend)
    for env_id in ("DoubleCircleSquare-v0", "CircleSquareHideAndSeek-v0", "LightDark-v0",
                   "CircleSquare-sparse-v0"):  # ported
        apx_torch.make_vec(env_id, 2, device="cpu")
    assert apx_torch.env_ids() == apx.env_ids()  # every id, since slice 7


def test_rollout_and_disabled_autoreset():
    venv, p = apx_torch.make_vec("LIDARLocMaze-v0", 8, device="cpu")
    g = torch.Generator().manual_seed(0)

    def policy(gen, obs):
        return {"action": torch.rand((8, 2), generator=gen) * 2 - 1,
                "prediction": torch.zeros(8, 2)}

    obs, s, (rew, te, tr) = apx_torch.rollout(venv, p, policy, g, 12)
    assert rew.shape == (12, 8) and te.dtype == torch.bool and torch.isfinite(rew).all()
    dvenv = apx_torch.vector_env(venv.env, 8, apx_torch.AutoResetMode.DISABLED)
    obs, s, _ = dvenv.reset(p, g)
    obs, s2, r, *_ = dvenv.step(s, policy(g, obs), p)
    assert torch.equal(s2.inner.t, torch.ones(8, dtype=torch.int32))


def test_single_env_api_matches_vector_disabled():
    """``make`` gives the env itself; its composite ``step`` (reward =
    base_reward - loss) agrees with the vector env's DISABLED step."""
    env, p = apx_torch.make("LIDARLocRoomsStatic-v0", device="cpu")
    g = torch.Generator().manual_seed(4)
    obs, s, info = env.reset(6, p, g)
    assert set(obs) == {"lidar", "odometry", "time_step"} and info["map_idx"].shape == (6,)
    act = {"action": torch.rand((6, 2), generator=g) * 2 - 1,
           "prediction": torch.rand((6, 2), generator=g) * 2 - 1}
    obs1, s1, r1, te1, tr1, info1 = env.step(s, act, p)
    venv = apx_torch.vector_env(env, 6, apx_torch.AutoResetMode.DISABLED)
    obs2, s2, r2, te2, tr2, info2 = venv.step(
        apx_torch.core.env.VectorState(inner=s, prev_done=torch.zeros(6, dtype=torch.bool)),
        act, p)
    assert torch.equal(r1, r2) and torch.equal(te1, te2) and torch.equal(tr1, tr2)
    for k in obs1:
        assert torch.equal(obs1[k], obs2[k]), k
    assert torch.equal(info1["prediction"]["loss"], info2["prediction"]["loss"])
    assert torch.equal(r1, info1["base_reward"] - info1["prediction"]["loss"])
