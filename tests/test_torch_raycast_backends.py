"""apx's A/B raycast backends in the port: each plain form against apx's
same form (jitted, as apx's env runs it), bitwise; the LIDAR envs under
every backend, beam tables and per-beam rectangles against apx's env with
the same settings, bitwise; and the port's forms against its own dense
casts at the tolerances apx pins between its forms (tests/test_lidar.py).

apx's ``"pallas"`` backend launches its Pallas kernel, which JAX runs on
the CPU only in interpret mode: its env is run here with ``pallas_call``
forced into interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lidar_env import _draw_fn, _eq, _within_one_ulp

import apx
import apx.ops.raycast as jr
from apx.data.floor_map import build_beam_tables as jax_build_beam_tables
from apx.data.floor_map import make_maze_bank as jax_maze_bank
from apx.data.floor_map import make_rooms_bank as jax_rooms_bank

import apx_torch
import apx_torch.ops.raycast as tr
from apx_torch.convert import lidar_state_from_numpy, map_bank_from_numpy
from apx_torch.data.floor_map import (BEAM_SIGNS, build_beam_tables, generate_maze_map,
                                      generate_rooms_map, make_rooms_bank)
from apx_torch.ops import raycast_cuda
from apx_torch.ops._launch import launched

torch.set_num_threads(1)
BACKENDS = ("bitslab2d", "bitslab", "windowed", "hybrid", "mxu_window", "pallas", "xla")


def _maps(n, rng):
    """Rooms and maze maps and random 32x32 walls."""
    out = [generate_rooms_map(i) for i in range(n // 3)]
    out += [np.pad(generate_maze_map(i), ((0, 11), (0, 11))) for i in range(n // 3)]
    out += list(rng.random((n - len(out), 32, 32)) < 0.3)
    return np.stack(out)


def _casts(maps, rng, reach=5.0, rays=11):
    """Origins inside free cells (a third at exact integers, a third at
    cell centres) and segments up to ``reach`` long."""
    n = maps.shape[0]
    origin = np.empty((n, 2), np.float32)
    for i, m in enumerate(maps):
        ys, xs = np.nonzero(~m)
        j = rng.integers(len(ys))
        frac = (0.0, 0.5, rng.uniform())[i % 3]
        origin[i] = (xs[j] + frac, ys[j] + frac)
    ang = rng.uniform(-np.pi, np.pi, (n, rays))
    rad = rng.uniform(0.0, reach, (n, rays))
    rad[:, 0] = reach
    ang[:, 0] = 0.0
    offs = np.stack([np.cos(ang) * rad, np.sin(ang) * rad], -1).astype(np.float32)
    return origin, (origin[:, None] + offs).astype(np.float32)


def test_pack_row_halves_and_bit_windows_match_apx():
    rng = np.random.default_rng(0)
    maps = _maps(24, rng)
    n = maps.shape[0]
    halves = tr.pack_row_halves(torch.from_numpy(maps))
    want = np.asarray(jax.vmap(jr.pack_row_halves)(jnp.asarray(maps)))
    assert halves.dtype == torch.int32
    np.testing.assert_array_equal(halves.numpy(), want)
    # apx's bank packs them from its row words; so does the port's.
    bank = make_rooms_bank(6, device="cpu")
    jbank = jax_rooms_bank(num_maps=6)
    idx = np.array([0, 3, 5, 1])
    np.testing.assert_array_equal(bank.fetch_halves(torch.from_numpy(idx)).numpy(),
                                  np.asarray(jbank.fetch_halves(jnp.asarray(idx))))
    np.testing.assert_array_equal(tr.pack_row_halves(bank.fetch(torch.from_numpy(idx))).numpy(),
                                  np.asarray(jbank.fetch_halves(jnp.asarray(idx))))
    bx = rng.integers(-20, 40, n).astype(np.int32)
    by = rng.integers(-20, 40, n).astype(np.int32)
    bx[:4], by[:4] = [0, -16, 31, 16], [0, 31, -16, 17]
    w1 = tr.bitslab_window(halves, torch.from_numpy(bx), 32)
    j1 = jax.jit(jax.vmap(jr.bitslab_window, in_axes=(0, 0, None)), static_argnums=2)(
        jnp.asarray(want), jnp.asarray(bx), 32)
    np.testing.assert_array_equal(w1.numpy(), np.asarray(j1))
    w2 = tr.bitslab_window_2d(halves, torch.from_numpy(bx), torch.from_numpy(by), 32)
    j2 = jax.jit(jax.vmap(jr.bitslab_window_2d, in_axes=(0, 0, 0, None)), static_argnums=3)(
        jnp.asarray(want), jnp.asarray(bx), jnp.asarray(by), 32)
    np.testing.assert_array_equal(w2.numpy(), np.asarray(j2))
    # In-map cells are the map's.
    np.testing.assert_array_equal(
        tr.bitslab_window_2d(halves, torch.zeros(n, dtype=torch.int32),
                             torch.zeros(n, dtype=torch.int32), 32).numpy(), maps[:, :16, :16])


def _bit_windows(maps, origin, anchor):
    halves = tr.pack_row_halves(torch.from_numpy(maps))
    base = torch.floor(torch.from_numpy(anchor)) - 7
    return halves, base


@pytest.mark.parametrize("rho", [None, 2, 6])
def test_bitslab_casts_match_apx_and_dense(rho):
    """``raycast_grid_bitslab`` and ``raycast_grid_bitslab2d`` (whole window
    and apx's static rho slices) bitwise apx's and the port's dense fast
    cast."""
    rng = np.random.default_rng(1 if rho is None else rho)
    maps = _maps(60, rng)
    reach = 5.0 if rho in (None, 6) else 1.0
    anchor, targets = _casts(maps, rng, reach)
    origin = anchor.copy()
    if rho == 6:  # a beam scan from within 1.0 of the window's anchor
        origin = anchor + rng.uniform(-1, 1, anchor.shape).astype(np.float32)
        origin[::5] = anchor[::5] + np.float32([-1.0, 0.0])
        targets = (targets - anchor[:, None] + origin[:, None]).astype(np.float32)
    halves, base = _bit_windows(maps, origin, anchor)
    t_o, t_t = torch.from_numpy(origin), torch.from_numpy(targets)
    dense = tr.raycast_grid(torch.from_numpy(maps), t_o, t_t, geos_typing=False)
    win2 = tr.bitslab_window_2d(halves, base[:, 0], base[:, 1], 32)
    bx, by = base[:, 0], base[:, 1]
    if rho is not None:
        lo, hi = max(6 - rho, 0), min(8 + rho, 16)
        win2, bx, by = win2[:, lo:hi, lo:hi], bx + lo, by + lo
    got2 = tr.raycast_grid_bitslab2d(win2, bx, by, t_o, t_t)
    jfn2 = jax.jit(jax.vmap(jr.raycast_grid_bitslab2d))
    want2 = jfn2(jnp.asarray(win2.numpy()), jnp.asarray(bx.numpy()), jnp.asarray(by.numpy()),
                 jnp.asarray(origin), jnp.asarray(targets))
    for g, w, d in zip(got2, want2, dense):
        _eq(w, g, "bitslab2d vs apx")
        assert torch.equal(g, d)
    if rho is None:
        win1 = tr.bitslab_window(halves, base[:, 0], 32)
        got1 = tr.raycast_grid_bitslab(win1, base[:, 0], t_o, t_t)
        want1 = jax.jit(jax.vmap(jr.raycast_grid_bitslab))(
            jnp.asarray(win1.numpy()), jnp.asarray(base[:, 0].numpy()), jnp.asarray(origin),
            jnp.asarray(targets))
        for g, w, d in zip(got1, want1, dense):
            _eq(w, g, "bitslab vs apx")
            assert torch.equal(g, d)


def test_per_ray_rectangles_match_apx_and_shared_window():
    rng = np.random.default_rng(3)
    dirs = tr.lidar_directions_np(8) * np.float32(5.0)
    rects = tr.beam_cell_rects(dirs, 16, 6.0, 9.0)
    assert rects == jr.beam_cell_rects(dirs, 16, 6.0, 9.0)
    assert max((x1 - x0) * (y1 - y0) for x0, x1, y0, y1 in rects) < 196
    n = 400
    maps = rng.random((n, 32, 32)) < 0.3
    kind = np.arange(n) % 4
    pos = rng.integers(1, 30, (n, 2)).astype(np.float32)
    pos[kind == 1] += np.float32(0.5)
    pos[kind >= 2] = rng.uniform(1, 30, ((kind >= 2).sum(), 2)).astype(np.float32)
    anchor = (np.floor(pos) - rng.integers(-1, 2, (n, 2))).astype(np.float32)
    halves, base = _bit_windows(maps, pos, anchor + 0.5)
    win = tr.bitslab_window_2d(halves, base[:, 0], base[:, 1], 32)
    t_o = torch.from_numpy(pos)
    t_t = t_o[:, None] + torch.from_numpy(dirs)
    shared = tr.raycast_grid_bitslab2d(win, base[:, 0], base[:, 1], t_o, t_t)
    got = tr.raycast_grid_bitslab2d_per_ray(win, base[:, 0], base[:, 1], t_o, t_t, rects)
    want = jax.jit(jax.vmap(functools.partial(jr.raycast_grid_bitslab2d_per_ray, rects=rects)))(
        jnp.asarray(win.numpy()), jnp.asarray(base[:, 0].numpy()),
        jnp.asarray(base[:, 1].numpy()), jnp.asarray(pos), jnp.asarray(t_t.numpy()))
    for g, s, w in zip(got, shared, want):
        assert torch.equal(g, s)
        _eq(w, g, "per-ray vs apx")


@pytest.mark.parametrize("typed", [False, True])
def test_windowed_cast_matches_apx(typed):
    """``raycast_grid_windowed`` (the window cut from the unpadded map) is
    bitwise apx's on its padded map, and within 1e-5 of the dense cast."""
    rng = np.random.default_rng(4)
    maps = _maps(48, rng)
    origin, targets = _casts(maps, rng, 5.0, 8)
    pad, radius = 8, 8
    t_args = (torch.from_numpy(maps), pad, torch.from_numpy(origin), torch.from_numpy(targets),
              radius)
    got = tr.raycast_grid_windowed(*t_args, geos_typing=typed)
    padded = jnp.asarray(np.pad(maps, ((0, 0), (pad, pad), (pad, pad))))
    want = jax.jit(jax.vmap(lambda o, org, t: jr.raycast_grid_windowed(
        o, pad, org, t, radius, geos_typing=typed)))(padded, jnp.asarray(origin),
                                                     jnp.asarray(targets))
    _eq(want[0], got[0], "windowed distances")
    dense = tr.raycast_grid(torch.from_numpy(maps), torch.from_numpy(origin),
                            torch.from_numpy(targets), geos_typing=typed)[0]
    # Where the window's start needs no clamp (origins below row and
    # column 31; see test_window_cut_clamps_as_dynamic_slice).
    inside = torch.from_numpy((np.floor(origin) <= 30).all(-1))
    assert int(inside.sum()) > 40
    assert float((got[0] - dense)[inside].abs().max()) <= 1e-5
    # Through K1's wrappers on CPU tensors: the window cut, then the cast
    # in the window frame, as the env runs it.
    win, base = tr.windowed_window(t_args[0], t_args[2], radius, pad)
    assert win.shape == (48, 2 * radius + 2, 2 * radius + 2)
    kernel = raycast_cuda.raycast_typed if typed else raycast_cuda.raycast_fast
    k1 = kernel(win, t_args[2] - base, t_args[3] - base[:, None])
    assert torch.equal(k1, got[0])


def test_window_cut_clamps_as_dynamic_slice():
    """Origins on the map's far edge: apx's dynamic slice clamps the
    window's start, and so does the port's cut."""
    rng = np.random.default_rng(5)
    maps = rng.random((6, 32, 32)) < 0.4
    origin = np.array([[32.0, 32.0], [31.5, 0.0], [0.0, 31.0], [32.0, 5.5], [0.0, 0.0],
                       [16.0, 32.0]], np.float32)
    pad, radius = 8, 8
    padded = np.pad(maps, ((0, 0), (pad, pad), (pad, pad)))
    win, base = tr.windowed_window(torch.from_numpy(maps), torch.from_numpy(origin), radius, pad)
    for i in range(6):
        start = (np.floor(origin[i]) - radius + pad).astype(int)
        want = np.asarray(jax.lax.dynamic_slice(jnp.asarray(padded[i]), (start[1], start[0]),
                                                (18, 18)))
        np.testing.assert_array_equal(win[i].numpy(), want)


def test_mxu_window_and_contact_cells_match_apx():
    rng = np.random.default_rng(6)
    maps = _maps(30, rng)
    origin, targets = _casts(maps, rng, 5.0, 8)
    origin[:3] = [[0.0, 0.0], [32.0, 32.0], [31.5, 0.25]]
    pad = 8
    padded = jnp.asarray(np.pad(maps, ((0, 0), (pad, pad), (pad, pad))))
    win, base = tr.extract_window_mxu(torch.from_numpy(maps), pad, torch.from_numpy(origin))
    jwin, jbase = jax.vmap(lambda o, p: jr.extract_window_mxu(o, pad, p))(
        padded, jnp.asarray(origin))
    fwin, _ = jax.jit(jax.vmap(lambda o, p: _extract_window_mxu_f32(o, pad, p)))(
        padded, jnp.asarray(origin))
    _eq(fwin, win, "mxu window, float32 products")
    _eq(jwin, win, "mxu window")
    _eq(jbase, base, "mxu base")
    t_o, t_t = torch.from_numpy(origin[3:]), torch.from_numpy(targets[3:])
    dist = tr.raycast_grid(torch.from_numpy(maps[3:]), t_o, t_t)[0]
    got = tr.contact_cells(t_o, t_t, dist)
    want = jax.jit(jax.vmap(jr.contact_cells))(jnp.asarray(origin[3:]), jnp.asarray(targets[3:]),
                                               jnp.asarray(dist.numpy()))
    assert got.dtype == torch.int32
    _eq(want, got, "contact cells")
    assert (got == -1).any() and (got >= 0).any()


def test_beam_tables_and_table_scan_match_apx():
    """``build_beam_tables`` bitwise apx's, and ``lidar_table_scan`` bitwise
    apx's and the dense fast cast at generic positions."""
    jbank = jax_maze_bank(num_maps=6).with_beam_tables()
    maps = np.asarray(jbank.maps)
    face, axis_x = build_beam_tables(maps)
    np.testing.assert_array_equal(face, np.asarray(jbank.beam_face))
    np.testing.assert_array_equal(axis_x, np.asarray(jbank.beam_axis))
    np.testing.assert_array_equal(BEAM_SIGNS, apx.data.floor_map.BEAM_SIGNS)
    rooms = make_rooms_bank(4, device="cpu").with_beam_tables()
    jface, jax_axis = jax_build_beam_tables(rooms.maps.numpy())
    assert torch.equal(rooms.beam_face, torch.from_numpy(np.asarray(jface)))
    assert torch.equal(rooms.beam_axis, torch.from_numpy(np.asarray(jax_axis)))
    rng = np.random.default_rng(7)
    n = 256
    bank_pos = rng.integers(0, 6, n)
    origin, _ = _casts(maps[bank_pos], rng)
    origin = (np.floor(origin) + rng.uniform(0.05, 0.95, origin.shape)).astype(np.float32)
    dirs = tr.lidar_directions_np(8) * np.float32(5.0)
    got = tr.lidar_table_scan(torch.from_numpy(face), torch.from_numpy(axis_x),
                              torch.from_numpy(bank_pos), torch.from_numpy(origin),
                              torch.from_numpy(dirs))
    want = jax.jit(jax.vmap(jr.lidar_table_scan, in_axes=(None, None, 0, 0, None)))(
        jbank.beam_face, jbank.beam_axis, jnp.asarray(bank_pos, jnp.int32), jnp.asarray(origin),
        jnp.asarray(dirs))
    _eq(want, got, "table scan vs apx")
    t_o = torch.from_numpy(origin)
    dense = tr.raycast_grid(torch.from_numpy(maps[bank_pos]), t_o,
                            t_o[:, None] + torch.from_numpy(dirs), geos_typing=False)[0]
    assert torch.equal(got, dense)


def _extract_window_mxu_f32(occ_padded, pad, origin, win=16):
    """apx's ``extract_window_mxu`` with its one-hot products in float32:
    XLA's CPU backend has no bfloat16 x bfloat16 -> float32 dot in a
    jitted batch, and the 0/1 sums are exact in both types."""
    hp, wp = occ_padded.shape
    o = origin.astype(jnp.float32)
    base = jnp.floor(o) - (win // 2 - 1)
    start = (base + pad).astype(jnp.int32)
    i = jnp.arange(win, dtype=jnp.int32)
    rsel = (i[:, None] + start[1]) == jnp.arange(hp, dtype=jnp.int32)[None, :]
    csel = (i[:, None] + start[0]) == jnp.arange(wp, dtype=jnp.int32)[None, :]
    w = jnp.einsum("rh,hw,cw->rc", rsel.astype(jnp.float32), occ_padded.astype(jnp.float32),
                   csel.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST)
    return w > 0.5, base


@pytest.fixture
def pallas_interpret(monkeypatch):
    """apx's backends as JAX runs them on the CPU: its Pallas kernels in
    interpret mode, its MXU window's products in float32."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(apx.envs.lidar_localization, "extract_window_mxu",
                        _extract_window_mxu_f32)


def _configs():
    out = [({"raycast_backend": b}, b) for b in BACKENDS]
    out.append(({"raycast_backend": "bitslab2d", "beam_rects": "on"}, "beam_rects"))
    out.append(({"use_beam_tables": True}, "beam_tables"))
    return out


def _make_pair(env_id, n, overrides):
    """apx's and the port's vector env with the same overrides; beam tables
    on both banks when asked."""
    jvenv, jp = apx.make_vec(env_id, num_envs=n)
    venv, p = apx_torch.make_vec(env_id, n, device="cpu")
    kw = dict(overrides)
    if kw.get("use_beam_tables"):
        jbank, bank = jp.map_bank.with_beam_tables(), p.map_bank.with_beam_tables()
        jvenv, jp = apx.make_vec(env_id, num_envs=n, map_bank=jbank, **kw)
        venv, p = apx_torch.make_vec(env_id, n, device="cpu", map_bank=bank, **kw)
    else:
        jvenv, jp = apx.make_vec(env_id, num_envs=n, **kw)
        venv, p = apx_torch.make_vec(env_id, n, device="cpu", **kw)
    return jvenv, jp, venv, p


def _rollout_pair(env_id, n, overrides, steps, seed=11):
    """apx's jitted env and the port's, stepped with the same actions and
    injected reset draws; yields (t, apx outputs, port outputs)."""
    jvenv, jp, venv, p = _make_pair(env_id, n, overrides)
    key = jax.random.PRNGKey(seed)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    draws = _draw_fn(jp)
    obs, s, _ = venv.reset(p, draws=draws(jax.random.split(key, n)))
    yield -1, (jobs, js), (obs, s), (jp, p)
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(seed)
    for t in range(steps):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        pred = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        jout = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(pred)}, jp)
        out = venv.step(s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(pred)},
                        p, reset_draws=draws(jax.random.split(jax.random.split(kt)[1], n)))
        js, s = jout[1], out[1]
        yield t, jout, out, (jp, p)


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMazeStatic-v0"])
@pytest.mark.parametrize("overrides,name", _configs(), ids=[c[1] for c in _configs()])
def test_backend_trajectory_bitwise_equal_to_apx(env_id, overrides, name, pallas_interpret):
    """Every backend's trajectory bitwise apx's under the same backend:
    obs, positions, the carried row halves (apx's padded map held to
    ``pad_occupancy`` of the port's), dones; rewards within one ulp."""
    n, ends = 16, 0
    for t, jout, out, (jp, p) in _rollout_pair(env_id, n, overrides, 150):
        what = f"{env_id} {name} step {t}"
        jobs, js = jout[:2]
        obs, s = out[:2]
        for k in jobs:
            _eq(jobs[k], obs[k], f"{what} obs {k}")
        ji = js.inner.inner if t >= 0 else js.inner.inner
        ti = s.inner.inner
        for leaf in ("pos", "initial_pos", "odo_pending", "occ"):
            _eq(getattr(ji, leaf), getattr(ti, leaf), f"{what} {leaf}")
        if p.needs_row_halves:  # apx's "auto" carries them too
            _eq(ji.row_halves, ti.row_halves, f"{what} row_halves")
        if ji.occ_padded is not None:
            _eq(ji.occ_padded, tr.pad_occupancy(ti.occ, p.ray_pad), f"{what} occ_padded")
        if t >= 0:
            _eq(jout[3], out[3], f"{what} terminated")
            _eq(jout[4], out[4], f"{what} truncated")
            _within_one_ulp(jout[2], out[2], f"{what} reward")
            ends += int(out[3].sum())
    assert ends >= n


# The tolerance each backend is held to against the port's dense casts,
# after apx's tests/test_lidar.py: bitwise for the bit, per-ray and table
# forms (positions too); the lidar within 1e-5 for the per-cast window
# frames (apx's test_windowed_raycast_matches_brute). The one-hot window
# is held on apx's own data (test_mxu_window_against_dense_on_apx_data).
_AGAINST_DENSE = {"bitslab2d": 0.0, "bitslab": 0.0, "beam_rects": 0.0, "beam_tables": 0.0,
                  "xla": 0.0, "windowed": 1e-5, "hybrid": 1e-5}


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMaze-v0"])
@pytest.mark.parametrize("name", sorted(_AGAINST_DENSE))
def test_backends_against_dense(env_id, name):
    """Each backend of the port against the port's dense ("auto") env, from
    the same draws and actions, over 25 steps (apx's short horizon: an
    ulp's difference in a window frame can later flip a wall-slide
    branch)."""
    kw = next(k for k, v in _configs() if v == name)
    n = 32
    _, _, venv, p = _make_pair(env_id, n, kw)
    dvenv, dp = apx_torch.make_vec(env_id, n, device="cpu", map_bank=p.map_bank)
    g = torch.Generator().manual_seed(3)
    draws = dvenv.env.draw_reset(n, dp, g)
    (o1, s1, _), (o2, s2, _) = venv.reset(p, draws=draws), dvenv.reset(dp, draws=draws)
    assert torch.equal(o1["lidar"], o2["lidar"])
    tol = _AGAINST_DENSE[name]
    for t in range(25):
        act = {"action": torch.rand((n, 2), generator=g) * 2 - 1, "prediction": torch.zeros(n, 2)}
        draws = dvenv.env.draw_reset(n, dp, g)
        o1, s1, r1, te1, *_ = venv.step(s1, act, p, reset_draws=draws)
        o2, s2, r2, te2, *_ = dvenv.step(s2, act, dp, reset_draws=draws)
        a, b = o1["lidar"], o2["lidar"]
        if tol == 0.0:
            assert torch.equal(a, b), f"{name} step {t}"
            assert torch.equal(s1.inner.inner.pos, s2.inner.inner.pos), f"{name} step {t}"
        else:
            assert float((a - b).abs().max()) <= tol, f"{name} step {t}"
        assert torch.equal(te1, te2)


def test_mxu_window_against_dense_on_apx_data():
    """apx's test_mxu_window_matches_dense on the port: LIDARLocMaze-v0,
    N=16, apx's reset key and actions, 25 steps; lidar within 3e-7,
    positions within 3e-6, terminations equal."""
    n = 16
    jvenv, jp = apx.make_vec("LIDARLocMaze-v0", num_envs=n)
    runs = [apx_torch.make_vec("LIDARLocMaze-v0", n, device="cpu", **kw)
            for kw in ({"raycast_backend": "mxu_window"}, {})]
    assert runs[0][1].use_mxu_window and not runs[1][1].use_mxu_window
    draws = _draw_fn(jp)
    key = jax.random.PRNGKey(0)
    carry = [venv.reset(p, draws=draws(jax.random.split(key, n)))[:2] for venv, p in runs]
    assert torch.equal(carry[0][0]["lidar"], carry[1][0]["lidar"])
    for t in range(25):
        k = jax.random.fold_in(key, t)
        act = {"action": torch.from_numpy(np.array(
            jax.random.uniform(k, (n, 2), minval=-1, maxval=1))), "prediction": torch.zeros(n, 2)}
        rd = draws(jax.random.split(jax.random.split(k)[1], n))
        outs = [venv.step(c[1], act, p, reset_draws=rd) for c, (venv, p) in zip(carry, runs)]
        carry = [o[:2] for o in outs]
        (o1, s1, _, te1, *_), (o2, s2, _, te2, *_) = outs
        assert float((o1["lidar"] - o2["lidar"]).abs().max()) <= 3e-7, f"step {t}"
        assert float((s1.inner.inner.pos - s2.inner.inner.pos).abs().max()) <= 3e-6
        assert torch.equal(te1, te2)


def test_pallas_backend_reset_is_untyped():
    """Under ``"pallas"`` the reset scan is K1's untyped cast, as apx's
    Pallas backend skips the GEOS typing: it differs from the typed scan
    exactly where a corner graze decides, and every later step equals the
    dense env's."""
    n = 256
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu", raycast_backend="pallas")
    dvenv, dp = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    g = torch.Generator().manual_seed(0)
    draws = venv.env.draw_reset(n, p, g)
    obs, s, _ = venv.reset(p, draws=draws)
    dobs, ds, _ = dvenv.reset(dp, draws=draws)
    inner = s.inner.inner
    targets = inner.pos[:, None] + p.beam_offsets
    fast = tr.raycast_grid(inner.occ, inner.pos, targets, geos_typing=False)[0]
    typed = tr.raycast_grid(inner.occ, inner.pos, targets, geos_typing=True)[0]
    assert torch.equal(obs["lidar"], (fast / torch.tensor(5.0)).clamp(-1, 1))
    assert torch.equal(dobs["lidar"], (typed / torch.tensor(5.0)).clamp(-1, 1))
    assert not torch.equal(fast, typed)
    before = launched("K1")
    act = {"action": torch.rand((n, 2), generator=g) * 2 - 1, "prediction": torch.zeros(n, 2)}
    o1, s1, *_ = venv.step(s, act, p, reset_draws=draws)
    o2, s2, *_ = dvenv.step(s, act, dp, reset_draws=draws)
    assert torch.equal(o1["lidar"], o2["lidar"])
    assert launched("K1") == before  # CPU tensors: the plain forms, no launch


@pytest.mark.parametrize("backend", ["bitslab2d", "windowed", "mxu_window"])
def test_move_length_rounding_site(backend, monkeypatch, pallas_interpret):
    """The move cast's |d| is contracted in apx's jitted step under the
    window-cut backends and rounded unfused under the others: written the
    other way, the port's steps differ from apx's."""
    from apx_torch.envs.lidar_localization import LIDARLocalizationParams

    def differing():
        bad = 0
        for t, jout, out, _ in _rollout_pair("LIDARLocRooms-v0", 16, {"raycast_backend": backend},
                                             60, seed=2):
            if t >= 0:
                bad += not np.array_equal(np.asarray(jout[1].inner.inner.pos),
                                          out[1].inner.inner.pos.numpy())
        return bad

    assert differing() == 0
    flipped = not LIDARLocalizationParams.move_len_contracted.fget(
        apx_torch.make_vec("LIDARLocRooms-v0", 2, device="cpu", raycast_backend=backend)[1])
    monkeypatch.setattr(LIDARLocalizationParams, "move_len_contracted",
                        property(lambda self: flipped))
    assert differing() > 0


@pytest.mark.parametrize("backend", ["bitslab2d", "windowed"])
def test_reset_from_host_draws_matches_apx_builder(backend):
    """The compat builders' reset from host maps under a window backend:
    obs bitwise apx's builder, and the bitslab state's row halves packed
    from the host maps as apx packs them."""
    from apx.compat.builders import reset_from_draws as jax_reset_from_draws

    from apx_torch.compat.builders import reset_from_draws

    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=4, raycast_backend=backend)
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", 4, device="cpu", raycast_backend=backend)
    maps = np.asarray(jp.map_bank.maps)[[0, 5, 9, 5]]
    rng = np.random.default_rng(2)
    pos = np.stack([np.stack(np.nonzero(~m)[::-1], -1)[rng.integers((~m).sum())] for m in maps])
    draws = {"occ": maps, "pos": (pos + 0.5).astype(np.float32),
             "map_idx": np.array([7, 8, 9, 10], np.uint32)}
    jobs, js, _ = jax.jit(lambda d: jax_reset_from_draws(jvenv.env, d, jp))(draws)
    obs, s, _ = reset_from_draws(venv.env, draws, p)
    for k in jobs:
        _eq(jobs[k], obs[k], f"obs {k}")
    if p.needs_row_halves:
        _eq(js.inner.row_halves, s.inner.row_halves, "row_halves")


def test_bitslab_state_and_beam_tables_carried_across_with_convert():
    """apx's mid-episode bitslab2d state (with its row halves) and its bank
    with beam tables, carried into the port (``convert``), step as apx's."""
    from apx_torch.convert import lidar_state_from_numpy, map_bank_from_numpy

    n = 16
    jbank = apx.make_vec("LIDARLocRooms-v0", num_envs=n)[1].map_bank.with_beam_tables()
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=n, raycast_backend="bitslab2d",
                             map_bank=jbank, use_beam_tables=True)
    bank = map_bank_from_numpy(jbank.maps, jbank.indices, jbank.free_counts, jbank.free_cells,
                               device="cpu", kind=jbank.kind, beam_face=jbank.beam_face,
                               beam_axis=jbank.beam_axis)
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu", raycast_backend="bitslab2d",
                                 map_bank=bank, use_beam_tables=True)
    assert p.beam_tables_active and p.needs_row_halves
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
                               i.map_idx, js.inner.t, js.prev_done, device="cpu",
                               row_halves=i.row_halves)
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
    _eq(js2.inner.inner.row_halves, s2.inner.inner.row_halves, "row_halves")
    _within_one_ulp(jr, r, "reward")


@pytest.mark.parametrize("site", ["as written", "unfused pull-back", "unfused |d|"])
@pytest.mark.parametrize("form", ["table scan", "bitslab2d"])
def test_new_forms_rounding_sites(form, site, monkeypatch):
    """The table scan and the 2-D bit-window cast equal apx's jitted forms
    at 4096 generic casts; rounded any other way at either site, the
    pull-back ``fma(t, |d|, -eps)`` or ``|d| = sqrt(fma(dy, dy, dx*dx))``,
    distances differ."""
    jbank = jax_maze_bank(num_maps=6).with_beam_tables()
    maps = np.asarray(jbank.maps)
    rng = np.random.default_rng(9)
    n = 4096
    bank_pos = rng.integers(0, 6, n)
    origin = np.empty((n, 2), np.float32)
    for i, b in enumerate(bank_pos):
        ys, xs = np.nonzero(~maps[b])
        j = rng.integers(len(ys))
        origin[i] = (xs[j] + rng.uniform(0.05, 0.95), ys[j] + rng.uniform(0.05, 0.95))
    dirs = tr.lidar_directions_np(8) * np.float32(5.0)
    t_o = torch.from_numpy(origin)
    t_t = t_o[:, None] + torch.from_numpy(dirs)
    if form == "table scan":
        want = jax.jit(jax.vmap(jr.lidar_table_scan, in_axes=(None, None, 0, 0, None)))(
            jbank.beam_face, jbank.beam_axis, jnp.asarray(bank_pos, jnp.int32),
            jnp.asarray(origin), jnp.asarray(dirs))
        face, axis_x = build_beam_tables(maps)

        def run():
            return tr.lidar_table_scan(torch.from_numpy(face), torch.from_numpy(axis_x),
                                       torch.from_numpy(bank_pos), t_o, torch.from_numpy(dirs))
    else:
        halves = tr.pack_row_halves(torch.from_numpy(maps[bank_pos]))
        base = torch.floor(t_o) - 7
        win = tr.bitslab_window_2d(halves, base[:, 0], base[:, 1], maps.shape[2])
        want = jax.jit(jax.vmap(jr.raycast_grid_bitslab2d))(
            jnp.asarray(win.numpy()), jnp.asarray(base[:, 0].numpy()),
            jnp.asarray(base[:, 1].numpy()), jnp.asarray(origin), jnp.asarray(t_t.numpy()))[0]

        def run():
            return tr.raycast_grid_bitslab2d(win, base[:, 0], base[:, 1], t_o, t_t)[0]

    if site == "unfused pull-back":
        monkeypatch.setattr(tr, "fma", lambda a, b, c: a * b + c)
    elif site == "unfused |d|":
        monkeypatch.setattr(tr, "seg_length", lambda d: tr.sqrt(d[..., 0] * d[..., 0]
                                                                + d[..., 1] * d[..., 1]))
    differing = int((run().numpy() != np.asarray(want)).sum())
    assert (differing == 0) if site == "as written" else (differing > 0), differing


def test_bench_beam_tables_switch():
    """The bench's ``--beam-tables`` sets the env's own ``use_beam_tables``,
    and the registered builder gives the bank the tables it reads."""
    from apx_torch.bench import AB_SWITCHES, _registered

    assert AB_SWITCHES["beam_tables"] == "use_beam_tables"
    _, params = _registered("LIDARLocRooms-v0")(2, torch.device("cpu"), use_beam_tables=True)
    assert params.beam_tables_active and params.map_bank.beam_face.shape == (256, 8, 2, 32, 32)
    _, plain = _registered("LIDARLocRooms-v0")(2, torch.device("cpu"))
    assert not plain.beam_tables_active and plain.map_bank.beam_face is None
