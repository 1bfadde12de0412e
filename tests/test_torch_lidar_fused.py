"""The LIDAR step and reset on the whole map as the plain forms of kernels S
and R (``ops.lidar_fused``), on the CPU: ``step_plain`` against apx's
jitted ``step_env`` and ``reset_plain`` against apx's jitted reset with
the same spawns injected (``apx.compat.builders.reset_from_draws``), on
LIDARLocRooms-v0, LIDARLocMaze-v0 (21x21: a 32-cell word of the map spans
rows), LIDARLocRoomsStatic-v0 and under ``raycast_backend="pallas"`` (the
untyped reset scan; apx's Pallas kernel in interpret mode); the edge
actions and positions of ``chip_smoke.lidar_step_cases``; the wrappers'
CPU dispatch and the env's choice of S and R by backend; the reset of only
the envs a mask selects (the NEXT_STEP autoreset's ``only``): the plain
form's poison in the others, the mask through the wrappers, and masked
rollouts bitwise the unmasked ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lidar_env import _eq
from test_torch_raycast_backends import pallas_interpret  # noqa: F401

import apx
from apx.compat.builders import reset_from_draws as jax_reset_from_draws

import apx_torch
from apx_torch.core.env import tree_map
from apx_torch.envs.lidar_localization import LIDARLocalizationEnv
from apx_torch.ops import lidar_fused, lidar_fused_cuda, lidar_step, raycast_cuda
from apx_torch.ops._launch import launched
from apx_torch.ops.lidar_step import STEP_LEAVES
from chip_smoke import lidar_step_cases

torch.set_num_threads(1)

CONFIGS = [("LIDARLocRooms-v0", {}), ("LIDARLocMaze-v0", {}), ("LIDARLocRoomsStatic-v0", {}),
           ("LIDARLocRooms-v0", {"raycast_backend": "pallas"})]
IDS = ["rooms", "maze", "rooms_static", "rooms_pallas"]


def _base(env):
    while hasattr(env, "env"):
        env = env.env
    return env


def _pair(env_id, n, kw):
    jvenv, jp = apx.make_vec(env_id, num_envs=n, **kw)
    _, p = apx_torch.make_vec(env_id, n, device="cpu", **kw)
    return _base(jvenv.env), jp, p


def _nan_eq(a, b: torch.Tensor, what: str):
    """Bitwise, NaN as NaN."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(a), torch.isnan(b).numpy(), err_msg=what)
        ok = ~np.isnan(a)
        np.testing.assert_array_equal(a.view(np.int32)[ok], b.numpy().view(np.int32)[ok],
                                      err_msg=what)
    else:
        _eq(a, b, what)


def _edge_state(jstate, p, n: int):
    """The first envs moved to ``lidar_step_cases``' corner, edge and
    lattice positions (on the map's size), the rest where the reset put
    them; actions: its finite edge actions (zeros, |a| exactly 1 and
    above, tiny and at the slide's threshold), then uniform in [-1.5,
    1.5]^2."""
    cases = lidar_step_cases(23, n)
    h, w = p.map_bank.map_hw
    edge_pos = cases["pos"][:8] * np.float32(w / 32.0)
    pos = np.asarray(jstate.pos).copy()
    pos[:8] = edge_pos
    action = cases["action"].copy()
    action[~np.isfinite(action).all(-1)] = 0.0
    return jstate.replace(pos=jnp.asarray(pos), initial_pos=jnp.asarray(pos)), action


@pytest.mark.parametrize("env_id,kw", CONFIGS, ids=IDS)
def test_step_plain_bitwise_equal_to_apx(env_id, kw, pallas_interpret):  # noqa: F811
    """``step_plain`` from apx's states, 40 steps with the same actions:
    every leaf S returns bitwise apx's jitted ``step_env`` (NaN as NaN),
    the first step from edge positions and actions; nothing launched."""
    n = 64
    jenv, jp, p = _pair(env_id, n, kw)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    _, js, _ = jax.jit(jax.vmap(lambda k: jenv.reset_env(k, jp)))(keys)
    step = jax.jit(jax.vmap(lambda k, s, a, pr: jenv.step_env(k, s, a, pr, jp)))
    js, action = _edge_state(js, p, n)
    rng = np.random.default_rng(7)
    before = [launched(k) for k in ("S", "R", "K1")]
    ends = 0
    for t in range(40):
        if t:
            action = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        r = step(keys, js, jnp.asarray(action), jnp.zeros((n, 2)))
        got = lidar_fused.step_plain(
            *(torch.from_numpy(np.array(x)) for x in (js.occ, action, js.pos, js.odo_pending,
                                                      js.initial_pos)),
            p.map_size, p.inv_map_size, p.beam_offsets, p.inv_range)
        assert tuple(got) == STEP_LEAVES
        want = {"pos": r.state.pos, "initial_pos": r.state.initial_pos,
                "odo_pending": r.state.odo_pending, "base_reward": r.base_reward,
                "terminated": r.terminated, "truncated": r.truncated,
                "target": r.prediction_target, "lidar": r.obs["lidar"],
                "odometry": r.obs["odometry"]}
        for k, v in want.items():
            _nan_eq(v, got[k], f"{env_id} {kw} step {t} {k}")
        ends += int(np.asarray(r.terminated).sum())
        js = r.state
    assert ends > 0
    assert [launched(k) for k in ("S", "R", "K1")] == before


def _spawns(p, n: int, rng):
    """(bank_pos, k) (N,) int64: every map in turn (or the static map) and
    a uniform free cell of it."""
    bank = p.map_bank
    if p.static_map:
        bank_pos = np.full(n, p.static_map_pos, np.int64)
    else:
        bank_pos = np.arange(n, dtype=np.int64) % bank.num_maps
    free = bank.free_counts.numpy()[bank_pos]
    return bank_pos, (rng.random(n) * free).astype(np.int64)


@pytest.mark.parametrize("env_id,kw", CONFIGS, ids=IDS)
def test_reset_plain_bitwise_equal_to_apx(env_id, kw, pallas_interpret):  # noqa: F811
    """``reset_plain`` from ``MapBank.spawn``'s row words and spawn cells
    against apx's jitted reset with the same map and spawn injected: the
    map, the position, the odometry flag, lidar (the typed scan, untyped
    under "pallas") and odometry bitwise; many spawns are cell centres
    whose beams graze wall corners (on the rooms maps)."""
    n = 512
    jenv, jp, p = _pair(env_id, n, kw)
    bank_pos, k = _spawns(p, n, np.random.default_rng(11))
    words, flat, index = p.map_bank.spawn(torch.from_numpy(bank_pos), torch.from_numpy(k))
    h, w = p.map_bank.map_hw
    got = lidar_fused.reset_plain(words, flat, w, p.beam_offsets, p.lidar_range,
                                  p.inv_map_size, typed=kw.get("raycast_backend") != "pallas")
    assert tuple(got) == lidar_fused.RESET_LEAVES
    occ = p.map_bank.maps.numpy()[bank_pos]
    flat_np = p.map_bank.free_cells.numpy()[bank_pos, k]
    pos = (np.stack([flat_np % w, flat_np // w], -1) + 0.5).astype(np.float32)
    draws = {"occ": occ, "pos": pos, "map_idx": index.numpy().astype(np.uint32)}
    jobs, js, _ = jax.jit(lambda d: jax_reset_from_draws(jenv, d, jp))(draws)
    _eq(js.occ, got["occ"], "occ")
    for k_, v in (("pos", js.pos), ("odo_pending", js.odo_pending), ("lidar", jobs["lidar"]),
                  ("odometry", jobs["odometry"])):
        _nan_eq(v, got[k_], f"{env_id} {kw} reset {k_}")
    if env_id == "LIDARLocMaze-v0":
        assert (h, w) == (21, 21)
    if env_id == "LIDARLocRooms-v0" and not kw:
        assert (got["lidar"] == 0).any()  # single-point grazes report 0 (typed)


def test_wrappers_run_the_plain_forms_on_the_cpu():
    """On CPU tensors ``lidar_fused_cuda.step`` / ``reset`` are the plain
    forms, bitwise, and launch nothing."""
    n = 32
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    g = torch.Generator().manual_seed(0)
    draws = venv.env.draw_reset(n, p, g)
    words, flat, _ = p.map_bank.spawn(draws["bank_pos"], draws["k"])
    before = launched("S"), launched("R")
    args = (words, flat, 32, p.beam_offsets, p.lidar_range, p.inv_map_size)
    for typed in (True, False):
        got, want = lidar_fused_cuda.reset(*args, typed), lidar_fused.reset_plain(*args, typed)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    r = want
    action = torch.rand((n, 2), generator=g) * 3 - 1.5
    step_args = (r["occ"], action, r["pos"], r["odo_pending"], r["pos"], p.map_size,
                 p.inv_map_size, p.beam_offsets, p.inv_range)
    got, want = lidar_fused_cuda.step(*step_args), lidar_fused.step_plain(*step_args)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (launched("S"), launched("R")) == before


@pytest.mark.parametrize("overrides,step_s,reset_r", [
    ({}, True, True), ({"raycast_backend": "xla"}, True, True),
    ({"raycast_backend": "pallas"}, True, True), ({"raycast_backend": "bitslab2d"}, False, True),
    ({"raycast_backend": "bitslab"}, False, True), ({"raycast_backend": "hybrid"}, False, True),
    ({"raycast_backend": "windowed"}, False, False),
    ({"raycast_backend": "mxu_window"}, False, False),
    ({"raycast_backend": "pallas_window"}, False, False),
    ({"raycast_backend": "pallas_window", "lidar_range": 9.0}, True, True),
    ({"use_beam_tables": True}, False, True)])
def test_env_chooses_s_and_r_by_backend(overrides, step_s, reset_r):
    """S where every cast of the step runs on the whole map, R where the
    reset scan does: the dense backends, and the window backends whose
    windows do not fit the range (which cast on the whole map, as apx's
    do); never with the beam tables' step scan. Where S runs, the move's
    |d| is the unfused one stage A computes."""
    bank = None
    if overrides.get("use_beam_tables"):
        _, p0 = apx_torch.make_vec("LIDARLocRooms-v0", 4, device="cpu")
        bank = p0.map_bank.with_beam_tables()
    kw = {"map_bank": bank} if bank is not None else {}
    _, p = apx_torch.make_vec("LIDARLocRooms-v0", 4, device="cpu", **overrides, **kw)
    assert (p.step_on_whole_map, p.reset_on_whole_map) == (step_s, reset_r)
    if p.step_on_whole_map:
        assert not p.move_len_contracted


def test_step_plain_equals_the_staged_k1_path():
    """``step_plain`` is F1's plain stages around the plain casts
    (``lidar_step.staged_step``) with the move's unfused |d|: the same
    leaves, bitwise, as the sequence written out with K1's CPU wrappers."""
    n = 64
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    g = torch.Generator().manual_seed(4)
    _, state, _ = venv.reset(p, g)
    s = state.inner.inner
    action = torch.rand((n, 2), generator=g) * 3 - 1.5

    def move(origin, targets, seg):
        return raycast_cuda.raycast_fast(s.occ, origin, targets, seg)

    def cast(origin, targets):
        return raycast_cuda.raycast_fast(s.occ, origin, targets)

    want = lidar_step.staged_step(lidar_step, action, s.pos, s.odo_pending, s.initial_pos,
                                  p.map_size, p.inv_map_size, p.beam_offsets, p.inv_range,
                                  move, cast, cast)
    got = lidar_fused.step_plain(s.occ, action, s.pos, s.odo_pending, s.initial_pos,
                                 p.map_size, p.inv_map_size, p.beam_offsets, p.inv_range)
    for k in STEP_LEAVES:
        assert torch.equal(got[k], want[k]), k


# ---- the reset of the envs a mask selects ---------------------------------


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise, NaN as NaN (float32 compared as its bits)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _assert_poisoned(got: dict, want: dict, only: torch.Tensor, what: str):
    """``got`` equals ``want`` bitwise on the envs ``only`` selects and holds
    ``lidar_fused.RESET_POISON`` in every slot of the others."""
    assert list(got) == list(want), what
    for k, v in got.items():
        assert _same(v[only], want[k][only]), f"{what} {k}: a selected env changed"
        skipped = v[~only]
        poison = lidar_fused.RESET_POISON[k]
        ok = torch.isnan(skipped) if v.is_floating_point() else skipped == poison
        assert bool(ok.all()), f"{what} {k}: a skipped env is not poisoned"


@pytest.mark.parametrize("fetch", [False, True], ids=["gathered", "fetch"])
@pytest.mark.parametrize("typed", [True, False], ids=["typed", "untyped"])
def test_reset_plain_poisons_exactly_the_skipped_envs(fetch, typed):
    """``reset_plain`` given ``only``: the selected envs' leaves bitwise the
    unmasked reset's, every slot of the others ``RESET_POISON`` (NaN
    positions, lidar and odometry, an all-wall map, ``odo_pending`` False,
    ``map_idx`` -1); the bank form equals ``MapBank.spawn``'s gathered
    operands and adds their ``map_idx``."""
    n = 64
    _, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    bank = p.map_bank
    bank_pos, k = (torch.from_numpy(x) for x in _spawns(p, n, np.random.default_rng(5)))
    words, flat, index = bank.spawn(bank_pos, k)
    scan = (32, p.beam_offsets, p.lidar_range, p.inv_map_size, typed)
    gathered = lidar_fused.reset_plain(words, flat, *scan)
    if fetch:
        args, kw = (bank.row_words, bank.free_cells), {"fetch": (bank_pos, k, bank.indices)}
        want = {**gathered, "map_idx": index}
        got = lidar_fused.reset_plain(*args, *scan, **kw)
        assert all(_same(got[key], want[key]) for key in want)
    else:
        args, kw, want = (words, flat), {}, gathered
    only = torch.from_numpy(np.random.default_rng(6).random(n) < 0.3)
    assert 0 < int(only.sum()) < n
    _assert_poisoned(lidar_fused.reset_plain(*args, *scan, only=only, **kw), want, only,
                     "reset_plain")
    _assert_poisoned(lidar_fused_cuda.reset(*args, *scan, only=only, **kw), want, only,
                     "reset on the CPU")


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocRooms-sparse-v0"])
def test_autoreset_mask_passes_through_the_wrappers(env_id):
    """``autoreset_from_draws(..., only=)`` from the vector env's outermost
    env (``TimeLimit``; on the ``-sparse`` id ``Sparsify``, the base
    wrapper, around it) reaches the LIDAR env: the selected envs' leaves
    are the explicit reset's, the others poisoned, and ``TimeLimit``'s
    counter restarts for all."""
    n = 32
    venv, p = apx_torch.make_vec(env_id, n, device="cpu")
    g = torch.Generator().manual_seed(2)
    _, state, _ = venv.reset(p, g)
    draws = venv.env.draw_reset(n, p, g)
    only = torch.arange(n) % 3 == 0
    obs, s, info = venv.env.autoreset_from_draws(draws, state.inner, p, only=only)
    want_obs, want_s, want_info = venv.env.reset_from_draws(draws, p)
    inner, want_inner = s.inner, want_s.inner
    assert torch.equal(s.t, want_s.t)
    got = {"occ": inner.occ, "pos": inner.pos, "odo_pending": inner.odo_pending,
           "lidar": obs["lidar"], "odometry": obs["odometry"], "map_idx": info["map_idx"]}
    want = {"occ": want_inner.occ, "pos": want_inner.pos,
            "odo_pending": want_inner.odo_pending, "lidar": want_obs["lidar"],
            "odometry": want_obs["odometry"], "map_idx": want_info["map_idx"]}
    _assert_poisoned(got, want, only, env_id)
    assert torch.equal(inner.bank_pos, want_inner.bank_pos)


@pytest.mark.parametrize("env_id", ["LightDark-v0", "CircleSquare-v0"])
def test_envs_without_a_masked_reset_ignore_the_mask(env_id):
    """The default ``autoreset_from_draws`` takes ``only`` and resets every
    env: the leaves equal the unmasked reset's."""
    n = 16
    venv, p = apx_torch.make_vec(env_id, n, device="cpu")
    g = torch.Generator().manual_seed(3)
    _, state, _ = venv.reset(p, g)
    draws = venv.env.draw_reset(n, p, g)
    only = torch.arange(n) % 2 == 0
    got = venv.env.autoreset_from_draws(draws, state.inner, p, only=only)
    want = venv.env.autoreset_from_draws(draws, state.inner, p)
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert _same(a, b)


@pytest.mark.parametrize("overrides,fetch", [
    ({}, True), ({"raycast_backend": "pallas"}, True), ({"raycast_backend": "hybrid"}, True),
    ({"raycast_backend": "bitslab2d"}, False), ({"raycast_backend": "pallas_window"}, False)])
def test_env_lets_r_read_the_bank_where_it_can(overrides, fetch, monkeypatch):
    """R reads the bank itself (``fetch``) wherever it runs on a whole,
    unsharded bank and no row halves are carried; the bit windows (row
    halves) and the window backends (no R) keep ``MapBank.spawn``."""
    n = 8
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu", **overrides)
    calls = {"spawn": 0, "fetch": 0}
    spawn, reset = type(p.map_bank).spawn, lidar_fused_cuda.reset

    def counted_spawn(self, *a):
        calls["spawn"] += 1
        return spawn(self, *a)

    def counted_reset(*a, **kw):
        calls["fetch"] += kw.get("fetch") is not None
        return reset(*a, **kw)

    monkeypatch.setattr(type(p.map_bank), "spawn", counted_spawn)
    monkeypatch.setattr(lidar_fused_cuda, "reset", counted_reset)
    venv.reset(p, torch.Generator().manual_seed(0))
    assert calls == ({"spawn": 0, "fetch": 1} if fetch else {"spawn": 1, "fetch": 0})


def _stagger(state, limit: int):
    """The vector state with env i's first episode started ``7 i`` steps
    before (mod the limit), so that its ``TimeLimit`` ends it early: the
    envs' dones spread over the steps."""
    t = (torch.arange(state.inner.t.shape[0], dtype=state.inner.t.dtype) * 7) % limit
    return type(state)(inner=type(state.inner)(inner=state.inner.inner, t=t),
                       prev_done=state.prev_done)


@pytest.mark.parametrize("timing", ["synchronised", "staggered"])
@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMaze-v0"])
def test_masked_rollout_bitwise_equal_to_unmasked(env_id, timing, monkeypatch):
    """A NEXT_STEP rollout of 205 steps with the reset computed only where
    ``prev_done`` is set (the plain form poisoning the rest) equals the
    rollout that resets every env, bitwise: obs, carried state, rewards,
    dones and info at every step. Synchronised: ``prev_done`` all False but
    on the two steps after the 100-step limit, when it is all True;
    staggered: the envs' resets on steps of their own."""
    n, steps = 16, 205
    venv, p = apx_torch.make_vec(env_id, n, device="cpu")
    limit = venv.env.max_episode_steps
    asked = []
    plain = LIDARLocalizationEnv.autoreset_from_draws

    def spy(self, draws, old_state, params, only=None):
        asked.append(None if only is None else int(only.sum()))
        return plain(self, draws, old_state, params, only=only)

    def unmasked(self, draws, old_state, params, only=None):
        return plain(self, draws, old_state, params)

    def run(autoreset):
        monkeypatch.setattr(LIDARLocalizationEnv, "autoreset_from_draws", autoreset)
        g = torch.Generator().manual_seed(17)
        rng = np.random.default_rng(17)
        obs, state, _ = venv.reset(p, g)
        if timing == "staggered":
            state = _stagger(state, limit)
        out = []
        for _ in range(steps):
            act = torch.from_numpy(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
            pred = torch.from_numpy(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
            obs, state, *rest = venv.step(state, {"action": act, "prediction": pred}, p, g)
            out.append(_leaves((obs, state, rest)))
        return out

    masked, whole = run(spy), run(unmasked)
    for t, (a, b) in enumerate(zip(masked, whole, strict=True)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            assert _same(x, y), f"{env_id} {timing} step {t} leaf {i}"
    assert len(asked) == steps and None not in asked
    if timing == "synchronised":
        assert [i for i, c in enumerate(asked) if c] == [limit, 2 * limit + 1]
        assert {asked[limit], asked[2 * limit + 1]} == {n}
    else:
        assert sum(0 < c < n for c in asked) >= n  # the envs' resets fall on other steps
        assert sum(asked) >= 2 * n  # every env reset at least twice
