"""apx_torch's plain raycast forms against the JAX package's.

The reference for "bitwise" is apx's ``raycast_grid`` as the env runs it:
jitted (``jax.jit(jax.vmap(...))``). XLA's CPU backend contracts the
multiply-adds of a fusion into FMAs: ``|d| = sqrt(fma(dy, dy, dx*dx))`` and
the pull-back ``fma(t_hit, |d|, -eps)``. The eager dense form rounds the
pull-back unfused, so it can differ from the jitted one by an ulp; the
port follows the jitted form, which is what apx's env computes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from apx.data.floor_map import generate_maze_map, generate_rooms_map
from apx.ops.raycast import lidar_directions_np as jax_dirs_np
from apx.ops.raycast import raycast_grid as jax_raycast

from apx_torch.core.numerics import fma
from apx_torch.ops.raycast import (_slab_axis, lidar_directions, lidar_directions_np,
                                   raycast_grid, seg_length)
from apx_torch.ops._launch import launched
from apx_torch.ops.raycast_cuda import raycast_fast, raycast_typed
from chip_smoke import EDGE_MAPS, EDGE_RAYS, edge_casts, edge_maps

torch.set_num_threads(1)

_jitted = {
    typed: jax.jit(jax.vmap(
        lambda occ, o, t, typed=typed: jax_raycast(occ, o, t, geos_typing=typed),
        in_axes=(0, 0, 0),
    ))
    for typed in (False, True)
}


def _maps():
    return {"rooms": generate_rooms_map(3), "maze": generate_maze_map(5)}


def _random_casts(occ, n, r, seed):
    """n origins at generic points of free cells, r segments each: random
    angles and lengths, with every fourth segment axis-aligned (d == 0 on
    one axis)."""
    rng = np.random.default_rng(seed)
    fy, fx = np.where(~occ)
    i = rng.integers(len(fy), size=n)
    origin = (np.stack([fx[i], fy[i]], -1) + rng.uniform(0.02, 0.98, (n, 2))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    ang[:, ::4] = rng.choice([0.0, np.pi / 2, np.pi, -np.pi / 2], size=ang[:, ::4].shape)
    length = rng.uniform(0.05, 6.0, (n, r))
    d = np.stack([np.cos(ang), np.sin(ang)], -1) * length[..., None]
    d[:, ::4][np.abs(d[:, ::4]) < 1e-6] = 0.0
    targets = (origin[:, None, :] + d).astype(np.float32)
    return origin, targets


def _centre_scans(occ):
    """8-beam scans from every free-cell centre (where corner grazes occur)."""
    fy, fx = np.where(~occ)
    origin = (np.stack([fx, fy], -1) + 0.5).astype(np.float32)
    targets = origin[:, None, :] + jax_dirs_np(8) * np.float32(5.0)
    return origin, targets.astype(np.float32)


def _compare(occ, origin, targets, typed):
    n = origin.shape[0]
    occs = np.broadcast_to(occ, (n, *occ.shape))
    ref = np.asarray(_jitted[typed](occs, origin, targets)[0])
    ours = raycast_grid(torch.from_numpy(occs.copy()), torch.from_numpy(origin),
                        torch.from_numpy(targets), geos_typing=typed)[0]
    np.testing.assert_array_equal(ours.numpy(), ref)
    return ours


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("kind", ["rooms", "maze"])
def test_random_casts_bitwise(kind, typed):
    occ = _maps()[kind]
    origin, targets = _random_casts(occ, 160, 8, seed=len(kind) + typed)  # 1280 casts
    ours = _compare(occ, origin, targets, typed)
    d = targets - origin[:, None]
    assert ((d == 0).any(-1)).sum() > 100  # axis-aligned segments were cast
    assert (ours.numpy() < np.linalg.norm(d, axis=-1) - 1e-4).any()  # and some hit


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("kind", ["rooms", "maze"])
def test_free_cell_centre_scans_bitwise(kind, typed):
    occ = _maps()[kind]
    origin, targets = _centre_scans(occ)
    ours = _compare(occ, origin, targets, typed)
    if typed and kind == "rooms":
        # The typed scan reports an isolated corner graze as distance 0.
        assert (ours == 0).sum() > 0


def test_typed_and_fast_differ_only_at_grazes():
    occ = _maps()["rooms"]
    origin, targets = _centre_scans(occ)
    args = (torch.from_numpy(np.broadcast_to(occ, (len(origin), *occ.shape)).copy()),
            torch.from_numpy(origin), torch.from_numpy(targets))
    fast = raycast_grid(*args, geos_typing=False)[0]
    typed = raycast_grid(*args, geos_typing=True)[0]
    assert (fast != typed).any()
    origin_g, targets_g = _random_casts(occ, 64, 8, seed=9)
    args = (torch.from_numpy(np.broadcast_to(occ, (64, *occ.shape)).copy()),
            torch.from_numpy(origin_g), torch.from_numpy(targets_g))
    assert torch.equal(raycast_grid(*args, geos_typing=False)[0],
                       raycast_grid(*args, geos_typing=True)[0])


def test_miss_returns_full_length_and_inf():
    occ = np.zeros((8, 8), bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    d, t = raycast_grid(torch.from_numpy(occ)[None], torch.tensor([[4.0, 4.0]]),
                        torch.tensor([[[4.5, 4.5]]]))
    np.testing.assert_allclose(float(d[0, 0]), np.sqrt(0.5), rtol=1e-6)
    assert torch.isinf(t).all()


def test_lidar_directions_match_apx():
    np.testing.assert_array_equal(lidar_directions_np(8), jax_dirs_np(8))
    assert torch.equal(lidar_directions(8), torch.from_numpy(jax_dirs_np(8)))


def test_cpu_wrappers_run_the_plain_forms():
    occ = _maps()["rooms"]
    origin, targets = _random_casts(occ, 8, 3, seed=4)
    args = (torch.from_numpy(np.broadcast_to(occ, (8, *occ.shape)).copy()),
            torch.from_numpy(origin), torch.from_numpy(targets))
    before = launched("K1")
    assert torch.equal(raycast_fast(*args), raycast_grid(*args, geos_typing=False)[0])
    assert torch.equal(raycast_typed(*args), raycast_grid(*args, geos_typing=True)[0])
    assert launched("K1") == before  # the CPU path launches no kernel
    with pytest.raises(TypeError):
        raycast_fast(args[0].float(), *args[1:])
    with pytest.raises(ValueError):
        raycast_fast(args[0], args[1][:4], args[2])


def _hull(near, far, size):
    """(N, R, K) slab pairs of K cells on one axis -> (N, R, K) mask of the
    hull of the cells with near <= 1 and far >= 0 (NaN fails both)."""
    ok = (near <= 1.0) & (far >= 0.0)
    idx = torch.arange(size)
    first = torch.where(ok, idx, size).amin(-1, keepdim=True)
    last = torch.where(ok, idx, -1).amax(-1, keepdim=True)
    return (idx >= first) & (idx <= last)


def _culled_cast(occ, origin, targets, seg, typed, eps=1e-3):
    """The cast as the redesigned K1 evaluates it: the slab test only on the
    cells of the column hull times the row hull (``_hull``), the flanks of a
    graze read from the whole map. Returns distances and the tested-cell
    mask (N, R, H, W)."""
    n, h, w = occ.shape
    o = origin[:, None, :]
    d = targets - o
    col = torch.arange(w, dtype=torch.float32)
    row = torch.arange(h, dtype=torch.float32)
    nx1, fx1 = _slab_axis(o[..., 0:1], d[..., 0:1], col, col + 1.0)
    ny1, fy1 = _slab_axis(o[..., 1:2], d[..., 1:2], row, row + 1.0)
    cells = _hull(ny1, fy1, h)[..., :, None] & _hull(nx1, fx1, w)[..., None, :]
    walls = occ[:, None] & cells
    nx, fx = nx1[:, :, None, :], fx1[:, :, None, :]
    ny, fy = ny1[:, :, :, None], fy1[:, :, :, None]
    inf = float("inf")

    def pulled(t):
        return torch.where(torch.isfinite(t), fma(t, seg, -eps).clamp_min(0.0), seg)

    if not typed:
        a = torch.maximum(nx.clamp_min(0.0), ny.clamp_min(0.0))
        b = torch.minimum(fx.clamp_max(1.0), fy.clamp_max(1.0))
        return pulled(torch.where(walls & (a <= b), a, inf).amin(dim=(-2, -1))), cells
    a = torch.maximum(nx, ny).clamp_min(0.0)
    b = torch.minimum(fx, fy).clamp_max(1.0)
    valid = walls & (a <= b)
    nd = valid & (a < b)
    pad = torch.nn.functional.pad(occ, (1, 1, 1, 1))[:, None]
    xm, xp = pad[..., 1:-1, :-2], pad[..., 1:-1, 2:]
    ym, yp = pad[..., :-2, 1:-1], pad[..., 2:, 1:-1]
    sx = (d[..., 0] >= 0.0)[:, :, None, None]
    sy = (d[..., 1] >= 0.0)[:, :, None, None]
    flank = torch.where(nx >= ny, torch.where(sy, yp, ym) | torch.where(sx, xm, xp),
                        torch.where(sx, xp, xm) | torch.where(sy, ym, yp))
    iso = valid & (a == b) & ~flank
    t_nd = torch.where(nd, a, inf).amin(dim=(-2, -1))
    iso_min = torch.where(iso, a, inf).amin(dim=(-2, -1))
    iso_max = torch.where(iso, a, -inf).amax(dim=(-2, -1))
    any_nd, any_iso = nd.flatten(2).any(-1), iso.flatten(2).any(-1)
    points = ~any_nd & any_iso
    t_hit = torch.where(any_nd & ~any_iso, t_nd, torch.where(points, iso_min, inf))
    return torch.where(points & (iso_min == iso_max), 0.0, pulled(t_hit)), cells


def _check_cull(occ_np, origin, targets):
    """The culled cast equals raycast_grid bitwise for both typings, and for
    segments inside the map its cells lie in the segment's bounding box
    with a one-cell margin."""
    occ = torch.from_numpy(occ_np)
    origin, targets = torch.from_numpy(origin), torch.from_numpy(targets)
    seg = seg_length(targets - origin[:, None])
    for typed in (False, True):
        want = raycast_grid(occ, origin, targets, seg, geos_typing=typed)[0]
        got, cells = _culled_cast(occ, origin, targets, seg, typed)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), typed
    _, h, w = occ.shape
    ends = torch.stack([origin[:, None].expand_as(targets), targets])  # (2, N, R, 2)
    inside = ((ends >= 0) & (ends <= torch.tensor([w, h]))).flatten(-2).all(-1).all(0)
    lo = ends.amin(0).floor() - 1  # (N, R, 2)
    hi = ends.amax(0).floor() + 1
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    in_box = ((xs >= lo[..., 0, None, None]) & (xs <= hi[..., 0, None, None])
              & (ys >= lo[..., 1, None, None]) & (ys <= hi[..., 1, None, None]))
    assert not (cells & ~in_box)[inside].any()
    return cells


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), kind=st.sampled_from(sorted(EDGE_MAPS)),
       r=st.sampled_from(EDGE_RAYS), centres=st.booleans())
def test_cull_bitwise_equal_to_dense(seed, kind, r, centres):
    """K1's cull (only the hull of the columns and of the rows whose slab
    pair has near <= 1 and far >= 0) changes no distance: drawn cases of
    ``chip_smoke.edge_casts`` on rooms, maze and random maps (32x32, 21x21,
    24x16, 7x5, 1x1), numpy-seeded from the drawn seed."""
    rng = np.random.default_rng(seed)
    occ = edge_maps(kind, 12, rng)
    _check_cull(occ, *edge_casts(occ, r, rng, centres))


@pytest.mark.parametrize("kind", ["rooms", "maze"])
def test_cull_on_centre_scans_with_grazes(kind):
    """The cull on the reset scans from every free-cell centre, where the
    typed scan meets isolated grazes; a cast tests far fewer cells than
    the map holds."""
    occ = _maps()[kind]
    origin, targets = _centre_scans(occ)
    cells = _check_cull(np.broadcast_to(occ, (len(origin), *occ.shape)).copy(), origin, targets)
    assert cells.flatten(2).sum(-1).float().mean() < 0.15 * occ.size


def _pallas_k1(occ, origins, targets, block_envs=8, eps=1e-3):
    """apx's K1 (``raycast_pallas._kernel``) launched as
    ``raycast_grid_pallas_batch`` launches it, in interpret mode."""
    from jax.experimental import pallas as pl

    from apx.ops.raycast_pallas import _kernel

    n, h, w = occ.shape
    r = origins.shape[1]
    occf = occ.reshape(n, h * w).astype(jnp.float32)
    d = (targets - origins).astype(jnp.float32)
    seg = jnp.linalg.norm(d, axis=-1)
    kernel = functools.partial(_kernel, n_rays=r, h=h, w=w, eps=eps)
    return pl.pallas_call(
        kernel,
        grid=(n // block_envs,),
        in_specs=[
            pl.BlockSpec((block_envs, h * w), lambda i: (i, 0)),
            pl.BlockSpec((block_envs, r, 2), lambda i: (i, 0, 0)),
            pl.BlockSpec((block_envs, r, 2), lambda i: (i, 0, 0)),
            pl.BlockSpec((block_envs, r), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((block_envs, r), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, r), jnp.float32),
        interpret=True,
    )(occf, origins.astype(jnp.float32), d, seg)


def test_fast_form_within_one_ulp_of_pallas_k1():
    # K1's body evaluates the pull-back t_hit*seg - eps as one FMA once
    # XLA compiles it, while apx's EAGER dense form rounds it unfused, so
    # the two disagree by an ulp on some casts. The port follows the
    # jitted dense form, which also contracts, so it sits within one ulp
    # of K1.
    occ = generate_rooms_map(3)
    origin, targets = _random_casts(occ, 16, 11, seed=3)
    occs = np.broadcast_to(occ, (16, *occ.shape)).copy()
    ref = np.asarray(jax.jit(_pallas_k1)(
        jnp.asarray(occs), jnp.asarray(np.broadcast_to(origin[:, None], targets.shape)),
        jnp.asarray(targets)))
    ours = raycast_fast(torch.from_numpy(occs), torch.from_numpy(origin),
                        torch.from_numpy(targets)).numpy()
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(ours.astype(np.float64) - ref) <= ulp)
    eager = np.stack([
        np.asarray(jax_raycast(jnp.asarray(occ), jnp.asarray(origin[n]),
                               jnp.asarray(targets[n]), geos_typing=False)[0])
        for n in range(16)
    ])
    eager_off = np.abs(eager.astype(np.float64) - ref)
    assert (eager_off > 0).any() and np.all(eager_off <= ulp)
