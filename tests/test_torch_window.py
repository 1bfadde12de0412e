"""The window backend of the port: K2's plain form and window arithmetic
against apx's, and ``raycast_backend="pallas_window"`` trajectories of the
LIDAR envs against apx's env with the same backend.

apx's window path casts in the window's frame (``origin - base``,
``targets - base``), so XLA rounds it at other sites than the dense path:
the port's window path is held to apx's window path, bitwise, and
``test_window_rounding_sites`` shows that each rounding site written in
the port is the one apx's jitted step has.

apx's window state carries the ray-padded map ``occ_padded``; the port's
does not (K2 cuts the padded map's window from ``occ``), so wherever apx's
leaf is compared it is held to ``pad_occupancy(port occ, ray_pad)``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lidar_env import _draw_fn, _eq, _within_one_ulp

import apx
from apx.compat.builders import reset_from_draws as jax_reset_from_draws
from apx.ops.window_pallas import extract_windows_pallas, make_window_extractor

import apx_torch
from apx_torch.compat.builders import reset_from_draws
from apx_torch.convert import lidar_state_from_numpy
from apx_torch.core.numerics import div, sqrt
from apx_torch.envs.lidar_localization import LIDARLocalizationEnv, LIDARLocalizationState
from apx_torch.ops import lidar_step, lidar_step_cuda, raycast_cuda, window_cuda
from apx_torch.ops._launch import launched
from apx_torch.ops.lidar_step import unfused_length
from apx_torch.ops.raycast import pad_occupancy
from apx_torch.ops.window import WIN_ROWS, clamp_starts, extract_windows, window_starts

torch.set_num_threads(1)
WIN = "pallas_window"


def _starts(rng, n, hp=64, wp=64):
    """Random in-range starts with 8-aligned rows, then the cases
    ``jax.lax.dynamic_slice`` brings into range: negative (counted from
    the end), past the end, unaligned."""
    s = np.stack([rng.integers(0, wp - 16 + 1, n),
                  rng.integers(0, (hp - WIN_ROWS) // 8 + 1, n) * 8], -1)
    edge = [[-3, -8], [wp - 4, hp - 8], [wp - 16, hp - WIN_ROWS], [100, -100], [0, 41],
            [-1, 5], [-70, 70], [3, -1]]
    s[:len(edge)] = edge
    return s.astype(np.int32)


def _padded_np(occ, pad):
    return np.pad(occ, ((0, 0), (pad, pad), (pad, pad)))


@pytest.mark.parametrize("n", [16, 64])
def test_extract_windows_matches_apx(n):
    """The port cuts from the unpadded map what apx's kernel (interpret
    mode, and its batching rule) cuts from the padded one."""
    rng = np.random.default_rng(n)
    occ = rng.random((n, 32, 32)) < 0.3
    starts = _starts(rng, n)
    padded = jnp.asarray(_padded_np(occ, 16))
    want = np.asarray(extract_windows_pallas(padded, jnp.asarray(starts), interpret=True))
    batched = np.asarray(jax.vmap(make_window_extractor(interpret=True))(
        padded, jnp.asarray(starts)))
    np.testing.assert_array_equal(batched, want)
    t_occ, t_starts = torch.from_numpy(occ), torch.from_numpy(starts)
    got = extract_windows(t_occ, t_starts, 16)
    assert got.dtype == torch.uint8 and got.shape == (n, WIN_ROWS, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # The wrapper runs the plain form on CPU tensors, and launches nothing.
    before = launched("K2")
    assert torch.equal(window_cuda.extract_windows(t_occ, t_starts, 16), got)
    assert launched("K2") == before


def test_extract_windows_matches_apx_fallback_paths():
    """apx's unbatched extractor and its vmapped fallback (a batch that is
    not a multiple of 8) slice with ``dynamic_slice``: the same windows."""
    rng = np.random.default_rng(3)
    occ = rng.random((13, 8, 40)) < 0.5
    starts = _starts(rng, 13, hp=40, wp=72)
    padded = jnp.asarray(_padded_np(occ, 16))
    ex = make_window_extractor(interpret=True)
    fallback = np.asarray(jax.vmap(ex)(padded, jnp.asarray(starts)))
    single = np.stack([np.asarray(ex(o, jnp.asarray(s))) for o, s in zip(padded, starts)])
    got = extract_windows(torch.from_numpy(occ), torch.from_numpy(starts), 16).numpy()
    np.testing.assert_array_equal(got, fallback)
    np.testing.assert_array_equal(got, single)


def _padded_gather(occ_padded, starts, win=16):
    """The gather K2 did before it read the unpadded map: the window
    ``occ_padded[n, y0:y0+24, x0:x0+win]`` of the padded map, starts
    brought into range against its dimensions."""
    n, hp, wp = occ_padded.shape
    x0, y0 = clamp_starts(starts.to(torch.int64), hp, wp, win)
    rows = y0[:, None] + torch.arange(WIN_ROWS)
    cols = x0[:, None] + torch.arange(win)
    env = torch.arange(n)[:, None, None]
    return occ_padded[env, rows[:, :, None], cols[:, None, :]].to(torch.uint8)


@pytest.mark.parametrize("pad", [8, 16])
@pytest.mark.parametrize("hw", [(32, 32), (20, 36)])
def test_unpadded_windows_equal_padded_gather(hw, pad):
    """``extract_windows(occ, starts, pad)`` is bitwise the gather on
    ``pad_occupancy(occ, pad)``, for starts in [-Hp - 4, Hp + 4] (and the
    same for columns): negative starts, starts past the end, and windows
    that lie partly or wholly in the padding."""
    h, w = hw
    hp, wp = h + 2 * pad, w + 2 * pad
    rng = np.random.default_rng(h * 100 + pad)
    n = 512
    occ = torch.from_numpy(rng.random((n, h, w)) < 0.4)
    starts = torch.from_numpy(np.stack([rng.integers(-wp - 4, wp + 5, n),
                                        rng.integers(-hp - 4, hp + 5, n)], -1).astype(np.int32))
    starts[:4] = torch.tensor([[-wp - 4, -hp - 4], [wp + 4, hp + 4], [-1, -1], [0, 0]])
    want = _padded_gather(pad_occupancy(occ, pad), starts)
    got = extract_windows(occ, starts, pad)
    assert torch.equal(got, want)
    assert torch.equal(window_cuda.extract_windows(occ, starts, pad), want)
    assert 0 < int(want.sum()) < want.numel()


def test_window_wrapper_rejects_bad_input():
    occ = torch.zeros((2, 32, 32), dtype=torch.bool)
    ok = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        window_cuda.extract_windows(occ, torch.zeros((2, 2), dtype=torch.int64), 16)
    with pytest.raises(ValueError):
        window_cuda.extract_windows(occ[:, :20], ok, 0)  # 20 rows < 24, no padding
    with pytest.raises(ValueError):
        window_cuda.extract_windows(occ, torch.zeros((3, 2), dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        window_cuda.extract_windows(occ, ok, -1)
    with pytest.raises(ValueError):
        window_cuda.extract_windows(occ, ok, 16, 0)  # an empty window


def _apx_windows(params, pos, occ_padded):
    """apx's own ``_make_window`` (vmapped): (window, base) per position."""
    env = apx.envs.lidar_localization.LIDARLocalizationEnv(params.map_bank)

    def one(p, o):
        _, win, base = env._make_window(types.SimpleNamespace(pos=p, occ_padded=o), params)
        return win, base

    return jax.jit(jax.vmap(one))(jnp.asarray(pos), jnp.asarray(occ_padded))


def test_window_starts_match_apx():
    """``window_starts`` against apx's arithmetic over a grid of positions
    in [0, 32]^2, integers, half-cells and the edges included. apx's
    extractor casts its input to uint8, so a map holding each cell's row
    (then its column) reads apx's start back from the window's first cell.
    On the env path the starts need no clamp."""
    _, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=8, raycast_backend=WIN)
    assert jp.ray_pad == 16
    xs = np.unique(np.concatenate([np.arange(33.0), np.arange(32.0) + 0.5,
                                   [1e-7, 7.999999, 31.999998, 32.0]])).astype(np.float32)
    pos = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2)
    n = pos.shape[0]
    rows, cols = np.indices((64, 64)).astype(np.uint8)
    win_x, base = _apx_windows(jp, pos, np.broadcast_to(cols, (n, 64, 64)))
    win_y, _ = _apx_windows(jp, pos, np.broadcast_to(rows, (n, 64, 64)))
    x0, y0a = np.asarray(win_x)[:, 0, 0], np.asarray(win_y)[:, 0, 0]
    starts, tbase = window_starts(torch.from_numpy(pos), 16, 16)
    assert starts.dtype == torch.int32 and tbase.dtype == torch.float32
    np.testing.assert_array_equal(starts.numpy(), np.stack([x0, y0a], -1).astype(np.int32))
    np.testing.assert_array_equal(tbase.numpy(), np.asarray(base))
    assert starts[:, 0].min() == 9 and starts[:, 0].max() == 41
    assert starts[:, 1].min() == 8 and starts[:, 1].max() == 40
    assert (starts[:, 1] % 8 == 0).all()


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMazeStatic-v0"])
def test_window_trajectory_bitwise_equal_to_apx(env_id):
    n = 16
    jvenv, jp = apx.make_vec(env_id, num_envs=n, raycast_backend=WIN)
    venv, p = apx_torch.make_vec(env_id, n, device="cpu", raycast_backend=WIN)
    assert jp.use_pallas_window and p.use_pallas_window and p.ray_pad == jp.ray_pad
    key = jax.random.PRNGKey(11)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    draws = _draw_fn(jp)
    obs, s, _ = venv.reset(p, draws=draws(jax.random.split(key, n)))
    for k in jobs:
        _eq(jobs[k], obs[k], f"reset {k}")
    _eq(js.inner.inner.occ_padded, pad_occupancy(s.inner.inner.occ, p.ray_pad),
        "reset occ_padded")
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(0)
    ends = 0
    for t in range(250):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        pred = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        jobs, js, jr, jte, jtr, _ = step(
            kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(pred)}, jp)
        _, reset_key = jax.random.split(kt)
        obs, s, r, te, tr, _ = venv.step(
            s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(pred)}, p,
            reset_draws=draws(jax.random.split(reset_key, n)))
        what = f"{env_id} step {t}"
        for k in jobs:
            _eq(jobs[k], obs[k], f"{what} obs {k}")
        ji, ti = js.inner.inner, s.inner.inner
        for leaf in ("pos", "initial_pos", "odo_pending", "occ"):
            _eq(getattr(ji, leaf), getattr(ti, leaf), f"{what} {leaf}")
        _eq(ji.occ_padded, pad_occupancy(ti.occ, p.ray_pad), f"{what} occ_padded")
        _eq(np.asarray(ji.map_idx).astype(np.int64), ti.map_idx, f"{what} map_idx")
        _eq(js.inner.t, s.inner.t, f"{what} t")
        _eq(jte, te, f"{what} terminated")
        _eq(jtr, tr, f"{what} truncated")
        _within_one_ulp(jr, r, f"{what} reward")
        ends += int(te.sum())
    assert ends >= 2 * n


@pytest.fixture(scope="module")
def apx_window_steps():
    """40 steps of apx's jitted window step at N=64 (zero predictions):
    (pre-step state, post-step obs, post-step state, reset draws, action)."""
    n = 64
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=n, raycast_backend=WIN)
    key = jax.random.PRNGKey(5)
    _, js, _ = jax.jit(jvenv.reset)(key, jp)
    step = jax.jit(jvenv.step)
    draws = _draw_fn(jp)
    rng = np.random.default_rng(0)
    out = []
    for t in range(40):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        o, js1, *_ = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.zeros((n, 2))},
                          jp)
        out.append((js, o, js1, draws(jax.random.split(jax.random.split(kt)[1], n)), act))
        js = js1
    return n, out


def _steps_differing(n, steps):
    """Steps (each from apx's own pre-step state) whose lidar or position
    differs from apx's."""
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu", raycast_backend=WIN)
    bad = 0
    for js, jobs, js1, draws, act in steps:
        i = js.inner.inner
        s = lidar_state_from_numpy(i.occ, i.pos, i.initial_pos, i.odo_pending, i.bank_pos,
                                   i.map_idx, js.inner.t, js.prev_done, device="cpu")
        obs, s1, *_ = venv.step(s, {"action": torch.from_numpy(act),
                                    "prediction": torch.zeros(n, 2)}, p, reset_draws=draws)
        same = (np.array_equal(np.asarray(jobs["lidar"]), obs["lidar"].numpy())
                and np.array_equal(np.asarray(js1.inner.inner.pos), s1.inner.inner.pos.numpy()))
        bad += not same
    return bad


_cast = LIDARLocalizationEnv._cast


def _window_frame_length(origin, targets, window):
    """The casts' |d| rounded unfused in the window frame."""
    return unfused_length(origin, targets, window[1])


def _dense_casts(kernel, state, origin, targets, window, seg=None):
    if seg is not None:  # the move's unfused |d|, in the map frame the cast now has
        seg = unfused_length(origin, targets)
    return _cast(kernel, state, origin, targets, None, seg)


def _targets_from_origin(kernel, state, origin, targets, window, seg=None):
    occ_win, base = window
    o = origin - base
    t = o[:, None, :] + (targets - origin[:, None, :])
    if seg is not None:
        d = t - o[:, None, :]
        seg = sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    return kernel(occ_win, o, t, seg)


def _unfused_lengths(kernel, state, origin, targets, window, seg=None):
    return _cast(kernel, state, origin, targets, window,
                 _window_frame_length(origin, targets, window))


def _fused_move_length(kernel, state, origin, targets, window, seg=None):
    return _cast(kernel, state, origin, targets, window, None)


_SITES = {
    "window frame -> map frame": ("_cast", _dense_casts),
    "targets - base -> (origin - base) + offset": ("_cast", _targets_from_origin),
    "contracted |d| of slide and beams -> unfused": ("_cast", _unfused_lengths),
    "unfused |d| of the move -> contracted": ("_cast", _fused_move_length),
    "fused pull-back -> unfused": ("pull_back", None),
    "step lidar * f32(1/range) -> / range": ("lidar", None),
}


@pytest.mark.parametrize("site", ["as written", *_SITES])
def test_window_rounding_sites(apx_window_steps, monkeypatch, site):
    """The port's window step equals apx's jitted window step on every
    step; written any other way, each rounding site makes steps differ."""
    n, steps = apx_window_steps
    if site == "as written":
        assert _steps_differing(n, steps) == 0
        return
    kind, fn = _SITES[site]
    if kind == "_cast":
        monkeypatch.setattr(LIDARLocalizationEnv, "_cast", staticmethod(fn))
    elif kind == "pull_back":
        grid = raycast_cuda.raycast_grid

        def unfused(occ, origin, targets, seg, eps, geos_typing):
            dist, t_hit = grid(occ, origin, targets, seg, eps=eps, geos_typing=geos_typing)
            if not geos_typing:
                dist = torch.where(torch.isfinite(t_hit), (t_hit * seg - eps).clamp_min(0.0), seg)
            return dist, t_hit

        monkeypatch.setattr(raycast_cuda, "raycast_grid", unfused)
    else:
        def divided(dist, pos, initial_pos, inv_range, inv_map_size):
            out = lidar_step.stage_d(dist, pos, initial_pos, inv_range, inv_map_size)
            lidar_range = float(np.float32(1.0) / np.float32(inv_range))  # 5.0
            out["lidar"] = div(dist, lidar_range).clamp(-1.0, 1.0)
            return out

        monkeypatch.setattr(lidar_step_cuda, "stage_d", divided)
    assert _steps_differing(n, steps) > 0


def test_window_reset_from_host_draws_matches_apx_builder():
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=8, raycast_backend=WIN)
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", 8, device="cpu", raycast_backend=WIN)
    maps = np.asarray(jp.map_bank.maps)[[0, 5, 9, 5, 1, 2, 3, 4]]
    rng = np.random.default_rng(2)
    pos = np.stack([np.stack(np.nonzero(~m)[::-1], -1)[rng.integers((~m).sum())] for m in maps])
    draws = {"occ": maps, "pos": (pos + 0.5).astype(np.float32),
             "map_idx": np.arange(7, 15, dtype=np.uint32)}
    jobs, js, _ = jax.jit(lambda d: jax_reset_from_draws(jvenv.env, d, jp))(draws)
    obs, s, _ = reset_from_draws(venv.env, draws, p)
    for k in jobs:
        _eq(jobs[k], obs[k], f"obs {k}")
    _eq(js.inner.occ_padded, pad_occupancy(s.inner.occ, p.ray_pad), "occ_padded")
    assert not hasattr(s.inner, "occ_padded") and s.inner.occ.shape == (8, 32, 32)


def test_window_state_carried_across_with_convert():
    """Start the port's window env from apx's mid-episode state."""
    n = 16
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=n, raycast_backend=WIN)
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu", raycast_backend=WIN)
    key = jax.random.PRNGKey(3)
    _, js, _ = jax.jit(jvenv.reset)(key, jp)
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(1)
    for t in range(5):
        act = {"action": jnp.asarray(rng.uniform(-1, 1, (n, 2)), jnp.float32),
               "prediction": jnp.zeros((n, 2))}
        _, js, *_ = step(jax.random.fold_in(key, t), js, act, jp)
    i = js.inner.inner
    s = lidar_state_from_numpy(i.occ, i.pos, i.initial_pos, i.odo_pending, i.bank_pos,
                               i.map_idx, js.inner.t, js.prev_done, device="cpu")
    _eq(i.occ_padded, pad_occupancy(s.inner.inner.occ, p.ray_pad), "occ_padded")
    act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    kt = jax.random.fold_in(key, 99)
    jobs, js2, jr, *_ = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.zeros((n, 2))},
                             jp)
    obs, s2, r, *_ = venv.step(
        s, {"action": torch.from_numpy(act), "prediction": torch.zeros(n, 2)}, p,
        reset_draws=_draw_fn(jp)(jax.random.split(jax.random.split(kt)[1], n)))
    for k in jobs:
        _eq(jobs[k], obs[k], f"obs {k}")
    _eq(js2.inner.inner.pos, s2.inner.inner.pos, "pos")
    _within_one_ulp(jr, r, "reward")


def test_window_backend_params_and_range_fallback():
    """``ray_pad`` and the range condition as apx's; past range 6 the
    backend casts on the whole map (apx still carrying occ_padded, which
    the port derives), equal to the default backend. The port's state has
    no occ_padded field under either backend."""
    for rng_ in (5.0, 6.0, 7.0):
        _, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=2, raycast_backend=WIN,
                             lidar_range=rng_)
        _, p = apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu", raycast_backend=WIN,
                                  lidar_range=rng_)
        assert (p.ray_pad, p.use_pallas_window) == (jp.ray_pad, jp.use_pallas_window)
    _, p = apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu")
    assert not p.use_pallas_window
    assert "occ_padded" not in {f.name for f in dataclasses.fields(LIDARLocalizationState)}
    n = 32
    runs = [apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu", lidar_range=7.0, **kw)
            for kw in ({}, {"raycast_backend": WIN})]
    g = torch.Generator().manual_seed(0)
    draws = runs[0][0].env.draw_reset(n, runs[0][1], g)
    carry = [v.reset(p, draws=draws)[1] for v, p in runs]
    # apx's window env, reset at the port's maps and positions, carries
    # the padded map that the port derives.
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=n, raycast_backend=WIN,
                             lidar_range=7.0)
    ti = carry[1].inner.inner
    _, js, _ = jax_reset_from_draws(jvenv.env, {"occ": ti.occ.numpy(), "pos": ti.pos.numpy(),
                                                "map_idx": ti.map_idx.numpy().astype(np.uint32)},
                                    jp)
    _eq(js.inner.occ_padded, pad_occupancy(ti.occ, runs[1][1].ray_pad), "occ_padded")
    for _ in range(30):
        act = {"action": torch.rand((n, 2), generator=g) * 2 - 1, "prediction": torch.zeros(n, 2)}
        draws = runs[0][0].env.draw_reset(n, runs[0][1], g)
        outs = [v.step(c, act, p, reset_draws=draws) for c, (v, p) in zip(carry, runs)]
        carry = [o[1] for o in outs]
        for k in outs[0][0]:
            assert torch.equal(outs[0][0][k], outs[1][0][k]), k
        assert torch.equal(carry[0].inner.inner.pos, carry[1].inner.inner.pos)


def test_window_state_has_the_dense_state_leaves():
    """At N=64 a window-backend state, after its reset and a step, holds
    the same leaves, shapes and dtypes as the dense backend's: six, with
    no padded map."""
    n = 64
    runs = [apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu", **kw)
            for kw in ({}, {"raycast_backend": WIN})]
    g = torch.Generator().manual_seed(1)
    draws = runs[0][0].env.draw_reset(n, runs[0][1], g)
    act = {"action": torch.rand((n, 2), generator=g) * 2 - 1, "prediction": torch.zeros(n, 2)}
    layouts = []
    for venv, p in runs:
        _, s, _ = venv.reset(p, draws=draws)
        _, s, *_ = venv.step(s, act, p, reset_draws=draws)
        inner = s.inner.inner
        layouts.append({f.name: (tuple(getattr(inner, f.name).shape),
                                 getattr(inner, f.name).dtype)
                        for f in dataclasses.fields(inner)})
    assert layouts[0] == layouts[1]
    assert len(layouts[1]) == 6 and layouts[1]["occ"] == ((n, 32, 32), torch.bool)
