"""apx_torch.compat (the gymnasium drop-in adapter) against apx.compat on
the CPU: LIDAR and LightDark trajectories in ``rng="reference"`` mode,
bitwise across episode boundaries (obs through the wire codec, rewards,
dones, infos, log stats and every dtype), and the adapter's units: the
losses' host forms, ``CompatLossFn``, the wire codec, the copied seeding,
the gymnasium spaces, the refused ``key_impl``, the rounding sites of the
reference-mode draws and the native mode. The image families are in
test_torch_compat_images.py, the frames in test_torch_render.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apx.compat as jc
from apx.registry import registry as jregistry
from _compat_parity import run_pair, same_tree

import apx_torch
import apx_torch.compat as tc
from apx_torch.compat.adapter import VectorAdapter, np_random

torch.set_num_threads(1)


@pytest.mark.parametrize("env_id,n,steps,overrides", [
    ("LIDARLocRooms-v0", 4, 103, {}),
    ("LIDARLocMaze-v0", 4, 102, {}),
    ("LIDARLocRoomsStatic-v0", 4, 102, {}),
    ("LIDARLocRooms-v0", 4, 102, {"raycast_backend": "pallas_window"}),
    ("LIDARLocRooms-sparse-v0", 4, 102, {}),
    ("LightDark-v0", 8, 110, {}),
], ids=["rooms", "maze", "rooms_static", "rooms_window", "rooms_sparse", "light_dark"])
def test_make_vec_matches_apx_bitwise(env_id, n, steps, overrides):
    """Reference mode, seed 0: every output bitwise apx's across the
    TimeLimit boundary and its NEXT_STEP reset (LIDAR: step 100's done and
    the host-generated maps after it; LightDark: 50-step limits and the
    early terminations), the regression log stats included. N is a multiple
    of 4: apx's jitted step rounds the last envs of other batch sizes in
    XLA's scalar loop remainder (lidar and odometry one ulp apart at N = 3),
    and the port follows the vector body."""
    _, _, _, dones = run_pair(env_id, n, steps, **overrides)
    assert dones >= n  # every env crossed its first episode end


# apx's single env is a batch of one: its jitted step runs entirely in XLA's
# scalar loop remainder, which rounds the position, the lidar and the
# odometry an ulp apart from the vector body that the port follows, and the
# ulps accumulate along the episode (up to 7e-7 over 100 steps). Ints and
# bools stay bitwise.
SINGLE_LIDAR_TOL = {k: 1e-5 for k in ("lidar", "odometry", "reward", "loss", "target")}


def test_make_single_lidar_matches_apx_with_log_stats():
    """``make`` (one env, no autoreset, RegressionLogWrapper): the episode
    to its TimeLimit end with ``info["stats"]``, a reset and more steps."""
    jenv, tenv, err, dones = run_pair("LIDARLocRooms-v0", None, 103, tol=SINGLE_LIDAR_TOL)
    assert dones == 1
    assert max(err.values(), default=0.0) < 1e-6, err
    assert type(tenv).__name__ == "RegressionLogWrapper"
    assert tenv.spec.max_episode_steps == 100


def test_light_dark_vector_stats_on_done_steps():
    """The vector log wrapper's stats appear on the steps where an env
    ends, with `_key` masks; held bitwise apx's by run_pair."""
    jenv = jc.make_vec("LightDark-v0", num_envs=4)
    tenv = tc.make_vec("LightDark-v0", num_envs=4, device="cpu")
    jenv.reset(seed=5)
    tenv.reset(seed=5)
    rng = np.random.default_rng(0)
    seen = 0
    for t in range(60):
        act = {"action": rng.uniform(-1, 1, (4, 2)).astype(np.float32),
               "prediction": rng.uniform(-1, 1, (4, 2)).astype(np.float32)}
        ja, ta = jenv.step(act), tenv.step(act)
        same_tree(ja, ta, f"step {t}")
        if "stats" in ta[4]:
            seen += 1
            assert set(ta[4]["stats"]) == {"scalar", "_scalar", "vector", "_vector"}
    assert seen >= 1


# ---- losses -----------------------------------------------------------------

def _loss_pairs():
    from apx.core import losses as J

    from apx_torch.core import losses as T

    rng = np.random.default_rng(3)
    pred = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    target = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    logits = rng.standard_normal((64, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 64).astype(np.int32)
    weight = (rng.uniform(size=64) > 0.5).astype(np.float32)
    mse = (J.MSELossFn(target_std=0.5).normalized, T.MSELossFn(target_std=0.5).normalized)
    return {
        "mse": (J.MSELossFn(), T.MSELossFn(), pred, target),
        "mse_normalized": (*mse, pred, target),
        "mse_normalized_unfused": (mse[0], dataclasses.replace(
            T.MSELossFn(target_std=0.5, fused_sum=False).normalized), pred, target),
        "ce": (J.CrossEntropyLossFn(5), T.CrossEntropyLossFn(5), logits, labels),
        "ce_normalized": (J.CrossEntropyLossFn(5).normalized,
                          T.CrossEntropyLossFn(5).normalized, logits, labels),
        "ce_float64_logits": (J.CrossEntropyLossFn(5).normalized,
                              T.CrossEntropyLossFn(5).normalized,
                              logits.astype(np.float64), labels),
        "weighted": (J.WeightedLossFn(inner=mse[0]), T.WeightedLossFn(inner=mse[1]), pred,
                     {"target": target, "weight": weight}),
        "affine": (J.AffineLossFn(inner=J.MSELossFn(), scale=0.3, offset=0.7),
                   T.AffineLossFn(inner=T.MSELossFn(), scale=0.3, offset=0.7), pred, target),
    }


@pytest.mark.parametrize("kind", sorted(_loss_pairs()))
def test_loss_numpy_bitwise_apx(kind):
    jloss, tloss, pred, target = _loss_pairs()[kind]
    same_tree(jloss.numpy(pred, target), tloss.numpy(pred, target), kind)


def test_zero_and_lambda_loss_numpy():
    from apx.core.losses import LambdaLossFn as JLambda
    from apx.core.losses import ZeroLossFn as JZero

    from apx_torch.core.losses import LambdaLossFn, ZeroLossFn

    same_tree(JZero().numpy((), (), (3, 2)), ZeroLossFn().numpy((), (), (3, 2)), "zero")
    fn = lambda p, t: np.abs(np.asarray(p) - t).sum(-1)  # noqa: E731
    x, y = np.ones((4, 2), np.float32), np.zeros((4, 2), np.float32)
    same_tree(JLambda(jax_fn=None, numpy_fn=fn).numpy(x, y),
              LambdaLossFn(fn=None, numpy_fn=fn).numpy(x, y), "lambda")
    with pytest.raises(NotImplementedError):
        LambdaLossFn(fn=lambda p, t: p).numpy(x, y)


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LightDark-v0", "CircleSquare-v0",
                                    "LIDARLocRooms-sparse-v0"])
def test_compat_loss_torch_matches_apx(env_id):
    """``CompatLossFn.torch`` (the port's own loss in the reference's
    rounding) is bitwise apx's ``LossFn.torch`` on the CPU, and ``.numpy``
    and the bounds are apx's."""
    from apx.compat.loss_adapter import CompatLossFn as JCompat

    from apx_torch.compat.loss_adapter import CompatLossFn
    from apx_torch.registry import _entry

    jentry, tentry = jregistry()[env_id], _entry(env_id)
    jenv = jentry.build()
    tenv = tentry.build(torch.device("cpu"))
    jl = jenv.loss_fn(jenv.default_params())
    tl = tenv.loss_fn(tenv.default_params())
    if jentry.sparse:
        from apx.core.losses import WeightedLossFn as JW

        from apx_torch.core.losses import WeightedLossFn as TW
        jl, tl = JW(inner=jl), TW(inner=tl)
    jc_, tc_ = JCompat(jl), CompatLossFn(tl)
    rng = np.random.default_rng(1)
    n = 257
    if env_id.startswith("CircleSquare"):
        pred = rng.standard_normal((n, 2)).astype(np.float32)
        target = rng.integers(0, 2, n).astype(np.int32)
    else:
        pred = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        target = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    if jentry.sparse:
        target = {"target": target, "weight": (rng.uniform(size=n) > 0.5).astype(np.float32)}
    same_tree(jc_.numpy(pred, target), tc_.numpy(pred, target), "numpy")
    ta = jc_.torch(pred, target)
    tb = tc_.torch(pred, target)
    assert ta.dtype == tb.dtype and ta.shape == tb.shape
    assert torch.equal(ta, tb), (ta - tb).abs().max()
    assert tc_.lower_bound == jc_.lower_bound
    assert tc_.blind_guessing_expected_value == jc_.blind_guessing_expected_value
    with pytest.raises(NotImplementedError, match="imports no JAX"):
        tc_.jax(pred, target)


def test_gym_env_loss_fn_is_stable_and_sparse():
    env = tc.make_vec("LIDARLocRooms-sparse-v0", num_envs=2, device="cpu", log_wrapper=False)
    assert env.loss_fn is env.loss_fn
    assert type(env.loss_fn.inner).__name__ == "WeightedLossFn"
    z = tc.CompatLossFn(apx_torch.core.losses.ZeroLossFn())
    assert z.numpy((), (), (2,)).shape == (2,) and z.torch((), (), (2,)).shape == (2,)


# ---- wire codec ---------------------------------------------------------------

@pytest.mark.parametrize("hw", [(32, 32), (21, 21), (5, 13)])
def test_wire_codec_matches_apx(hw):
    """The packed bytes are apx's, and the round trip is bitwise the f32
    map obs (values {0, 1/255})."""
    from apx.compat.wire import _lidar_map_codec as jcodec

    from apx_torch.compat.wire import _lidar_map_codec as tcodec

    h, w = hw
    occ = np.random.default_rng(h * w).uniform(size=(7, h, w)) < 0.4
    m = (occ.astype(np.float32) / np.float32(255.0))[..., None]
    jenc, jdec = jcodec(h, w)
    tenc, tdec = tcodec(h, w)
    jp = np.asarray(jax.jit(jenc)({"map": jnp.asarray(m), "lidar": jnp.zeros(7)})["map"])
    tp = tenc({"map": torch.from_numpy(m), "lidar": torch.zeros(7)})["map"].numpy()
    same_tree(jp, tp, "packed")
    back = tdec({"map": tp})["map"]
    same_tree(m, back, "round trip")
    same_tree(jdec({"map": jp})["map"], back, "decode")


def test_wire_codec_only_for_dynamic_lidar():
    from apx_torch.compat.wire import wire_codec_for

    for env_id, has in (("LIDARLocRooms-v0", True), ("LIDARLocRoomsStatic-v0", False),
                        ("LightDark-v0", False), ("CircleSquare-v0", False)):
        core = tc.make_core(env_id, 2, device="cpu")
        assert (wire_codec_for(core.base, core.params) is not None) == has, env_id


# ---- seeding, spaces, options -------------------------------------------------

@pytest.mark.parametrize("seed", [None, 0, 7, 2**40])
def test_np_random_equals_gymnasium(seed):
    from gymnasium.utils import seeding

    ours, ours_seed = np_random(seed)
    theirs, their_seed = seeding.np_random(seed)
    if seed is not None:
        assert ours_seed == their_seed
        np.testing.assert_array_equal(ours.integers(0, 2**32, 16), theirs.integers(0, 2**32, 16))
        np.testing.assert_array_equal(ours.normal(size=8), theirs.normal(size=8))
    assert type(ours) is type(theirs)
    with pytest.raises(ValueError):
        np_random(-1)


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocRoomsStatic-v0", "LightDark-v0",
                                    "CircleSquareInverted-v0", "TinyImageNetLoc-v0",
                                    "LIDARLocRooms-sparse-v0",
                                    "CircleSquareHideAndSeekNoPrediction-v0"])
def test_gym_spaces_match_apx(env_id):
    j = jc.make_vec(env_id, num_envs=3, log_wrapper=False)
    t = tc.make_vec(env_id, num_envs=3, device="cpu", log_wrapper=False)
    for name in ("single_observation_space", "single_action_space", "observation_space",
                 "action_space", "single_prediction_space", "single_prediction_target_space",
                 "prediction_target_space"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.metadata == j.metadata
    assert t.spec.max_episode_steps == j.spec.max_episode_steps
    js, ts = jc.make(env_id), tc.make(env_id, device="cpu")
    for name in ("observation_space", "action_space", "prediction_space"):
        assert getattr(ts, name) == getattr(js, name), name


def test_key_impl_refused():
    with pytest.raises(ValueError, match="key_impl"):
        tc.make_vec("LIDARLocRooms-v0", num_envs=2, device="cpu", rng="native", key_impl="rbg")
    with pytest.raises(ValueError, match="key_impl"):
        tc.make("CircleSquare-v0", device="cpu", key_impl="unsafe_rbg")
    with pytest.raises(ValueError, match="render_mode"):
        tc.make_vec("LightDark-v0", 2, device="cpu", render_mode="human")


def test_make_vec_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tc.make_vec("LightDark-v0", 2).core.device.type == "cuda"
    else:
        for fn in (lambda: tc.make_vec("LIDARLocRooms-v0", 2), lambda: tc.make("LightDark-v0"),
                   lambda: tc.make_core("CircleSquare-v0", 2)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()


# ---- rounding sites -----------------------------------------------------------

def test_compat_rounding_sites():
    """The two sites where reference-mode LightDark rounds host noise,
    against apx's jitted adapter code: the reset builder (``jit_reset_draws``
    over ``reset_from_draws``) and the step's overwrite (``apply_step_draws``
    inside ``jit_raw_step``). XLA-CPU contracts both into
    ``fma(noise, (1 - b) * 0.3, pos)`` with standard-normal noise (no folded
    sqrt 2: the noise is an input here); the unfused form differs on this
    data, so the test tells the two apart."""
    from apx.compat.builders import apply_step_draws as japply
    from apx.compat.builders import reset_from_draws as jreset
    from apx.core.env import APStepResult as JResult
    from apx.envs.light_dark import LightDarkEnv as JLD
    from apx.envs.light_dark import LightDarkState as JState

    from apx_torch.compat.builders import apply_step_draws, reset_from_draws
    from apx_torch.core.env import APStepResult
    from apx_torch.envs.light_dark import LightDarkEnv, LightDarkState, brightness

    n = 4096
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    noise = rng.standard_normal((n, 2)).astype(np.float32)
    jenv = JLD()
    jp = jenv.default_params()
    tenv = LightDarkEnv(device="cpu")
    tp = tenv.default_params()

    jobs = jax.jit(lambda d: jreset(jenv, d, jp)[0])({"pos": pos, "noise": noise})
    tobs = reset_from_draws(tenv, {"pos": pos, "noise": noise}, tp)[0]
    same_tree(np.asarray(jobs["noisy_position"]), tobs["noisy_position"].numpy(), "reset site")

    def jstep(pos, noise):
        r = JResult(obs={"noisy_position": pos}, state=JState(pos=pos),
                    base_reward=jnp.zeros(n), terminated=jnp.zeros(n, bool),
                    truncated=jnp.zeros(n, bool), info={}, prediction_target=pos)
        return japply(jenv, r, {"noise": noise}, jp).obs["noisy_position"]

    tpos = torch.from_numpy(pos)
    r = APStepResult(obs={"noisy_position": tpos}, state=LightDarkState(pos=tpos),
                     base_reward=torch.zeros(n), terminated=torch.zeros(n, dtype=torch.bool),
                     truncated=torch.zeros(n, dtype=torch.bool), info={},
                     prediction_target=tpos)
    tstep = apply_step_draws(tenv, r, {"noise": noise}, tp).obs["noisy_position"]
    ref = np.asarray(jax.jit(jstep)(pos, noise))
    same_tree(ref, tstep.numpy(), "step site")

    std = (1.0 - brightness(tpos, tp)) * tp.noise_scale
    unfused = (tpos + torch.from_numpy(noise) * std[:, None]).clamp(-2, 2).numpy()
    assert (unfused != ref).sum() > 100


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "CircleSquare-v0", "TinyImageNetLoc-v0",
                                    "LightDark-v0"])
def test_reference_step_key_is_used_only_by_light_dark(env_id):
    """apx's reference mode feeds PRNGKey(0) to its step: of the families,
    only LightDark's step draws from the key (its obs noise, which the host
    draws overwrite); the others' step results do not depend on it."""
    entry = jregistry()[env_id]
    env = entry.build()
    params = env.default_params()
    n = 4
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    _, state, _ = jax.vmap(env.reset_env, in_axes=(0, None))(keys, params)
    act = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (n, 2)), jnp.float32)
    pred = jnp.zeros((n, 2), jnp.float32)

    @jax.jit
    def step(key):
        ks = jax.random.split(key, n)
        return jax.vmap(env.step_env, in_axes=(0, 0, 0, 0, None))(ks, state, act, pred, params)

    a, b = step(jax.random.PRNGKey(0)), step(jax.random.PRNGKey(1))
    differ = [k for k, (x, y) in enumerate(zip(jax.tree_util.tree_leaves(a),
                                               jax.tree_util.tree_leaves(b)))
              if not np.array_equal(np.asarray(x), np.asarray(y))]
    if env_id == "LightDark-v0":
        assert not np.array_equal(np.asarray(a.obs["noisy_position"]),
                                  np.asarray(b.obs["noisy_position"]))
        np.testing.assert_array_equal(np.asarray(a.state.inner.pos),
                                      np.asarray(b.state.inner.pos))
        assert len(differ) == 1
    else:
        assert differ == []


# ---- native mode, the core without gymnasium ----------------------------------

@pytest.mark.parametrize("env_id,n,steps", [("LIDARLocRooms-v0", 4, 102),
                                            ("LightDark-v0", 8, 60),
                                            ("CircleSquare-v0", 4, 20)])
def test_native_rng_shapes_ranges_determinism(env_id, n, steps):
    """rng="native": the port's own trajectories (torch.Generator seeded
    from the seed): obs inside the spaces, the same seed gives the same
    trajectory, another seed another."""
    runs = []
    for seed in (3, 3, 4):
        env = tc.make_vec(env_id, num_envs=n, device="cpu", rng="native", log_wrapper=False)
        obs, _ = env.reset(seed=seed)
        rng = np.random.default_rng(0)
        out = [obs]
        for _ in range(steps):
            obs, reward, term, trunc, info = env.step({
                "action": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                "prediction": np.zeros((n, 2), np.float32)})
            assert env.observation_space.contains(obs), env_id
            assert reward.dtype == np.float64 and np.isfinite(reward).all()
            out.append(obs)
        runs.append(out)
    for a, b in zip(runs[0], runs[1]):
        same_tree(a, b, "same seed")
    assert any(not np.array_equal(a[k], b[k]) for a, b in zip(runs[0], runs[2]) for k in a)


def test_core_records_timings_on_cpu():
    core = tc.make_core("LIDARLocRooms-v0", 4, device="cpu", rng="native")
    core.record_timings = True
    core.reset(seed=0)
    for _ in range(3):
        core.step({"action": np.zeros((4, 2), np.float32),
                   "prediction": np.zeros((4, 2), np.float32)})
    row = core.timings[-1]
    assert {"upload_s", "issue_s", "transfer_s", "compose_s", "decode_s", "tracker_s"} <= set(row)
    # The map crosses as bits: 4 x 32 x 4 bytes instead of 4 x 32 x 32 x 4.
    assert row["unencoded_bytes"] - row["bytes"] == 4 * 32 * 32 * 4 - 4 * 32 * 4
    assert isinstance(core, VectorAdapter)
