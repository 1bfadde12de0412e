"""The LIDAR step cut into F1's four plain stages (``ops.lidar_step``) and
the NEXT_STEP merge with the MSE loss and reward (``ops.merge``), on the
CPU: the staged step against apx's jitted step over whole trajectories
under four raycast backends; each stage against the step's arithmetic
written as one function (as it was before the cut) on edge actions; the
plain merge against ``tree_select`` and the loss path as
``VectorAPEnv.step`` composed them, values and prediction gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_lidar_env import _eq, _within_one_ulp
from test_torch_raycast_backends import _rollout_pair, pallas_interpret  # noqa: F401

import apx_torch
from apx_torch.core.env import AutoResetMode, tree_map, tree_select
from apx_torch.core.numerics import fma, sqrt, sum_squares
from apx_torch.ops import lidar_step
from apx_torch.ops._launch import launched
from apx_torch.ops.geometry import normalize_into_unit_ball
from apx_torch.ops.raycast import raycast_grid, seg_length
from apx_torch.wrappers.time_limit import TimeLimit, TimeLimitState
from chip_smoke import lidar_step_cases, lidar_step_inputs, lidar_step_stage_args

torch.set_num_threads(1)


@pytest.mark.parametrize("backend", ["auto", "pallas_window", "windowed", "bitslab2d"])
def test_staged_step_bitwise_equal_to_apx(backend, pallas_interpret):  # noqa: F811
    """250 steps of LIDARLocRooms-v0 through the plain stages and the plain
    merge against apx's jitted step under the same backend (apx's Pallas
    window kernel in interpret mode): obs, positions, odometry origins,
    the time counter and dones bitwise, rewards within one ulp (as the
    dense trajectory test holds them); nothing launched on the CPU."""
    n, ends = 16, 0
    before = launched("F1"), launched("F2")
    for t, jout, out, _ in _rollout_pair("LIDARLocRooms-v0", n, {"raycast_backend": backend},
                                         250, seed=4):
        what = f"{backend} step {t}"
        for k in jout[0]:
            _eq(jout[0][k], out[0][k], f"{what} obs {k}")
        ji, ti = jout[1].inner.inner, out[1].inner.inner
        for leaf in ("pos", "initial_pos", "odo_pending", "occ"):
            _eq(getattr(ji, leaf), getattr(ti, leaf), f"{what} {leaf}")
        _eq(jout[1].inner.t, out[1].inner.t, f"{what} t")
        if t >= 0:
            _eq(jout[3], out[3], f"{what} terminated")
            _eq(jout[4], out[4], f"{what} truncated")
            _within_one_ulp(jout[2], out[2], f"{what} reward")
            ends += int(out[3].sum())
    assert ends >= 2 * n
    assert (launched("F1"), launched("F2")) == before


def _monolithic(action, pos, cast, odo_pending, initial_pos, params):
    """The step's arithmetic as one function, as ``step_env`` wrote it
    before it was cut into stages (the dense backend: every cast on the
    whole map, the move's |d| unfused); ``cast(origin, targets, seg)``
    gives the distances. Returns its intermediates by the stages' names."""
    base_reward = fma(-1e-3, sum_squares(action), 0.1)
    a = normalize_into_unit_ball(action)
    total = seg_length(a)
    direction = a / torch.where(total == 0.0, 1.0, total)[:, None]
    move_to = (pos + a)[:, None, :]
    d = move_to - pos[:, None, :]
    seg = sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    d2w = cast(pos, move_to, seg)[:, 0]
    pos1 = fma(direction, d2w[:, None], pos)
    rem = total - d2w
    rem_vec = direction * rem[:, None]
    keep = rem_vec > 1e-5
    n_keep = keep.sum(dim=-1)
    v_single = torch.where(keep, rem_vec, 0.0).amax(dim=-1)
    cand_diag = torch.where((n_keep == 2)[:, None], rem_vec, v_single[:, None].expand(-1, 2))
    cand = torch.eye(2, dtype=torch.float32) * cand_diag[:, None, :]
    cand_dist = cast(pos1, pos1[:, None, :] + cand, None)
    use0 = cand_dist[:, 0] > 0.0
    sel_cand = torch.where(use0[:, None], cand[:, 0], cand[:, 1])
    sel_diag = torch.where(use0, cand_diag[:, 0], cand_diag[:, 1])
    sel_dist = torch.where(use0, cand_dist[:, 0], cand_dist[:, 1])
    unit = sel_cand / torch.where(sel_diag == 0.0, 1.0, sel_diag)[:, None]
    do_slide = (total > 0.0) & (rem > 1e-5) & (n_keep > 0)
    pos2 = torch.where(do_slide[:, None], fma(unit, sel_dist[:, None], pos1), pos1)
    pos2 = torch.where((total > 0.0)[:, None], pos2, pos)
    size = params.map_size
    terminated = (pos2 < 0.0).any(dim=-1) | (pos2 >= size).any(dim=-1)
    new_initial = torch.where(odo_pending[:, None], pos2, initial_pos)
    pos2 = torch.minimum(pos2.clamp_min(0.0), size)
    beam_targets = pos2[:, None, :] + params.beam_offsets
    dist = cast(pos2, beam_targets, None)
    return {
        "a": {"base_reward": base_reward, "total": total, "direction": direction,
              "move_to": move_to, "seg": seg},
        "b": {"pos1": pos1, "rem": rem, "n_keep": n_keep, "cand_diag": cand_diag, "cand": cand,
              "cand_targets": pos1[:, None, :] + cand},
        "c": {"pos": pos2, "initial_pos": new_initial,
              "odo_pending": torch.zeros_like(odo_pending), "terminated": terminated,
              "truncated": torch.zeros_like(terminated),
              "target": fma(pos, 2.0 * params.inv_map_size, -1.0), "beam_targets": beam_targets},
        "d": {"lidar": (dist * params.inv_range).clamp(-1.0, 1.0),
              "odometry": (pos2 - new_initial) * params.inv_map_size},
    }, (d2w, cand_dist, dist)


def _staged(action, pos, cast, odo_pending, initial_pos, params):
    a = lidar_step.stage_a(action, pos, True)
    d2w = cast(pos, a["move_to"], a["seg"])[:, 0]
    b = lidar_step.stage_b(pos, a["direction"], a["total"], d2w)
    cand_dist = cast(b["pos1"], b["cand_targets"], None)
    c = lidar_step.stage_c(pos, b["pos1"], a["total"], b["rem"], b["n_keep"], b["cand"],
                           b["cand_diag"], cand_dist, odo_pending, initial_pos, params.map_size,
                           params.inv_map_size, params.beam_offsets)
    dist = cast(c["pos"], c["beam_targets"], None)
    d = lidar_step.stage_d(dist, c["pos"], c["initial_pos"], params.inv_range,
                           params.inv_map_size)
    return {"a": a, "b": b, "c": c, "d": d}


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        g, w = got[k], want[k]
        nan = torch.isnan(w) if w.dtype == torch.float32 else torch.zeros_like(w, dtype=torch.bool)
        assert torch.equal(torch.isnan(g) if g.dtype == torch.float32 else nan, nan), (what, k)
        assert torch.equal(_bits(g)[~nan], _bits(w)[~nan]), (what, k)


def _edge_state(params, n: int):
    """Envs at free cell centres of the first rooms map, with actions:
    zeros, |a| exactly 1 along each axis and on (0.6, 0.8), |a| > 1, and
    unit moves into each of the four neighbours (walls where the map has
    them), then random ones."""
    bank = params.map_bank
    occ = bank.fetch(torch.zeros(n, dtype=torch.int64))
    free = np.argwhere(~occ[0].numpy())  # (row, col)
    rng = np.random.default_rng(5)
    cells = free[rng.integers(len(free), size=n)]
    pos = torch.from_numpy(cells[:, ::-1].astype(np.float32) + 0.5)
    edge = [[0, 0], [-0.0, 0.0], [1, 0], [0, 1], [-1, 0], [0, -1], [0.6, 0.8], [-0.6, 0.8],
            [3, 4], [-2, 0.5], [1.5, 0], [0, -1.5], [0.7, 0.7], [-0.7, -0.7], [1e-6, 0],
            [0.5, 0]]
    action = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    action[:len(edge)] = edge
    # Moves into each neighbour of envs whose neighbour is a wall.
    for i in range(len(edge), n):
        r, c = cells[i]
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            rr, cc = r + dy, c + dx
            if not (0 <= rr < occ.shape[1] and 0 <= cc < occ.shape[2]) or occ[0, rr, cc]:
                action[i] = (dx * 0.75, dy * 0.75)
                break
    return occ, pos, torch.from_numpy(action)


def test_stages_equal_the_monolithic_step_on_edge_actions():
    """Each stage's outputs equal the one-function step's intermediates on
    edge actions (zeros, |a| exactly 1, |a| > 1, moves into adjacent walls)
    with K1's plain cast on a rooms map; and, with the casts' distances
    set so that |a| - d2w lands on the slide's 1e-5 threshold and its
    float32 neighbours, on ``chip_smoke.lidar_step_cases``."""
    _, params = apx_torch.make_vec("LIDARLocRooms-v0", 4, device="cpu")
    n = 256
    occ, pos, action = _edge_state(params, n)
    odo = torch.arange(n) % 3 == 0
    initial = pos + 0.25

    def k1(origin, targets, seg):
        return raycast_grid(occ, origin, targets, seg, geos_typing=False)[0]

    want, (d2w, _, _) = _monolithic(action, pos, k1, odo, initial, params)
    got = _staged(action, pos, k1, odo, initial, params)
    for stage in "abcd":
        _same(got[stage], want[stage], f"stage {stage} on a rooms map")
    assert (d2w < want["a"]["total"]).any() and (want["b"]["n_keep"] > 0).any()

    x = lidar_step_inputs(lidar_step_cases(17, 512), "cpu")
    forced = iter([x["d2w"][:, None], x["cand_dist"], x["dist"]])

    def injected(origin, targets, seg):
        return next(forced)

    want, _ = _monolithic(x["action"], x["pos"], injected, x["odo_pending"], x["initial_pos"],
                          params)
    forced = iter([x["d2w"][:, None], x["cand_dist"], x["dist"]])
    got = _staged(x["action"], x["pos"], injected, x["odo_pending"], x["initial_pos"], params)
    for stage in "abcd":
        _same(got[stage], want[stage], f"stage {stage} on lidar_step_cases")
    rem = want["b"]["rem"]
    assert (rem == np.float32(1e-5)).any()
    assert ((rem > np.float32(1e-5)) & (rem <= np.float32(1.0000002e-5))).any()


def test_stage_args_cover_every_stage():
    """``chip_smoke.lidar_step_stage_args`` (the card's yardstick inputs)
    run through the plain stages on the CPU: stage A with and without the
    unfused length and in a window frame, the others once."""
    _, params = apx_torch.make_vec("LIDARLocRooms-v0", 4, device="cpu")
    x = lidar_step_inputs(lidar_step_cases(17, 64), "cpu")
    args = lidar_step_stage_args(x, params)
    assert [len(args[s]) for s in "abcd"] == [3, 1, 1, 1]
    seg = [lidar_step.stage_a(*a)["seg"] for a in args["a"]]
    assert seg[2] is None and not torch.equal(seg[0], seg[1])


def _old_merge(venv, state, act, params, reset_draws, step_draws):
    """``VectorAPEnv.step``'s NEXT_STEP composition written as before the
    fused merge: the TimeLimit-wrapped step and reset, ``tree_select`` of
    every leaf, the masked base reward and dones, the derived obs from the
    merged state, the masked loss and reward."""
    env, mask = venv.env, state.prev_done
    loss_fn = env.loss_fn(params)
    r = env.step_env(state.inner, act["action"], act["prediction"], params, step_draws)
    reset_obs, reset_state, reset_info = env.autoreset_from_draws(reset_draws, state.inner,
                                                                  params)
    obs = tree_select(mask, reset_obs, r.obs)
    inner = tree_select(mask, reset_state, r.state)
    base = torch.where(mask, 0.0, r.base_reward)
    term = mask.logical_not() & r.terminated
    trunc = mask.logical_not() & r.truncated
    info = tree_select(mask, reset_info, r.info)
    obs = env._merge_derived_obs(obs, inner, params)
    loss = torch.where(mask, 0.0, loss_fn(act["prediction"], r.prediction_target))
    reward = torch.where(mask, 0.0, loss_fn.reward(base, loss, act["prediction"],
                                                   r.prediction_target))
    info = env.compose_info(info, base, r.prediction_target, loss, act["prediction"], params)
    return obs, inner, reward, term, trunc, info, term | trunc


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMaze-v0", "LightDark-v0"])
def test_plain_merge_equals_tree_select_and_loss(env_id):
    """The plain merge through ``VectorAPEnv.step`` equals the composition
    it replaced, bitwise (every obs, state and info leaf, the reward, the
    dones, the loss; the obs keys in the same order), with a third of the
    envs reset and some running out of time; and so does the gradient of
    the reward and the loss in the prediction."""
    n = 64
    venv, p = apx_torch.make_vec(env_id, n, device="cpu")
    g = torch.Generator().manual_seed(2)
    _, state, _ = venv.reset(p, g)
    for _ in range(3):
        act = venv.env.action_space(p).sample(g, (n,))
        _, state, *_ = venv.step(state, act, p, g)
    state = dataclasses.replace(state, prev_done=torch.arange(n) % 3 == 0)
    state.inner.t[1::5] = venv.env.max_episode_steps - 1
    for grad in (False, True):
        act = venv.env.action_space(p).sample(g, (n,))
        if grad:
            act["prediction"] = act["prediction"].clone().requires_grad_()
        step_draws = venv.env.draw_step(n, p, g)
        draws = venv.env.draw_reset(n, p, g)
        obs, s, reward, term, trunc, info = venv.step(state, act, p, reset_draws=draws,
                                                      step_draws=step_draws)
        w_obs, w_inner, w_reward, w_term, w_trunc, w_info, w_done = _old_merge(
            venv, state, act, p, draws, step_draws)
        assert list(obs) == list(w_obs)
        for a, b in zip(_leaves((obs, s.inner, reward, term, trunc, info, s.prev_done)),
                        _leaves((w_obs, w_inner, w_reward, w_term, w_trunc, w_info, w_done)),
                        strict=True):
            assert torch.equal(_bits(a.detach()), _bits(b.detach()))
        if grad:
            weights = torch.rand(n, generator=g)
            grads = [torch.autograd.grad((r * weights).sum() + 0.5 * i["prediction"]["loss"].sum(),
                                         act["prediction"], retain_graph=True)[0]
                     for r, i in ((reward, info), (w_reward, w_info))]
            assert torch.equal(_bits(grads[0]), _bits(grads[1]))
            assert grads[0].abs().max() > 0


class _CountingTimeLimit(TimeLimit):
    """A ``TimeLimit`` subclass: the merge leaves its counter to its own
    ``step_env``."""


def _every_leaf_equal(got, want):
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert torch.equal(_bits(a.detach()), _bits(b.detach()))


@pytest.mark.parametrize("env_id, autoreset", [
    ("LIDARLocRooms-sparse-v0", None), ("LightDark-sparse-v0", None),
    ("CircleSquare-v0", AutoResetMode.NEXT_STEP), ("LIDARLocRooms-v0", "subclass")])
def test_next_step_merge_of_other_losses_and_wrappers(env_id, autoreset):
    """Every NEXT_STEP step goes through the one merge (``ops.merge_cuda``
    sends the losses F2 does not compute, and the CPU, to ``ops.merge``):
    the ``-sparse`` ids' weighted loss over a wrapped ``TimeLimit``,
    cross-entropy, and a ``TimeLimit`` subclass (whose counter is not
    folded: ``split_counter``) equal the composition the merge replaced,
    bitwise, with a third of the envs reset."""
    n = 64
    kw = {} if autoreset in (None, "subclass") else {"autoreset": autoreset}
    venv, p = apx_torch.make_vec(env_id, n, device="cpu", **kw)
    if autoreset == "subclass":
        limit = venv.env
        venv = dataclasses.replace(venv, env=_CountingTimeLimit(
            limit.env, limit.max_episode_steps, limit.issue_termination))
        assert venv.env.split_counter("state")[2] is None
    assert venv.autoreset is AutoResetMode.NEXT_STEP
    g = torch.Generator().manual_seed(5)
    _, state, _ = venv.reset(p, g)
    for _ in range(3):
        _, state, *_ = venv.step(state, venv.env.action_space(p).sample(g, (n,)), p, g)
    state = dataclasses.replace(state, prev_done=torch.arange(n) % 3 == 0)
    act = venv.env.action_space(p).sample(g, (n,))
    step_draws = venv.env.draw_step(n, p, g)
    draws = venv.env.draw_reset(n, p, g)
    before = launched("F2")
    obs, s, reward, term, trunc, info = venv.step(state, act, p, reset_draws=draws,
                                                  step_draws=step_draws)
    assert launched("F2") == before
    w_obs, w_inner, w_reward, w_term, w_trunc, w_info, w_done = _old_merge(
        venv, state, act, p, draws, step_draws)
    assert list(obs) == list(w_obs)
    _every_leaf_equal((obs, s.inner, reward, term, trunc, info, s.prev_done),
                      (w_obs, w_inner, w_reward, w_term, w_trunc, w_info, w_done))


@pytest.mark.parametrize("issue_termination", [True, False])
def test_counter_rule_of_time_limit(issue_termination):
    """``Counter.tick`` is the rule ``TimeLimit.step_env`` applies: t + 1,
    the step that reaches the limit terminating (``issue_termination``) or
    truncating, the other flag passed through; ``split_counter`` gives the
    inner env and state and ``join_counter`` rebuilds the wrapper's."""
    limit = TimeLimit(None, 5, issue_termination=issue_termination)
    t = torch.tensor([0, 3, 4, 7], dtype=torch.int32)
    term = torch.tensor([False, True, False, False])
    trunc = torch.tensor([True, False, False, False])
    t1, te, tr = limit.counter(t).tick(term, trunc)
    out = torch.tensor([False, False, True, True])
    assert t1.tolist() == [1, 4, 5, 8] and t1.dtype == torch.int32
    assert te.tolist() == (term | out if issue_termination else term).tolist()
    assert tr.tolist() == (trunc if issue_termination else trunc | out).tolist()
    env, inner, counter = limit.split_counter(TimeLimitState(inner="inner", t=t))
    assert env is None and inner == "inner" and counter.t is t and counter.limit == 5
    assert counter.observe is issue_termination
    obs, state = limit.join_counter({"x": t}, "inner", t1, counter.time_obs(t1))
    assert state == TimeLimitState(inner="inner", t=t1)
    assert torch.equal(obs["time_step"], limit._time_obs(t1))
