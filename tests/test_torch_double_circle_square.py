"""DoubleCircleSquare in the port against apx: the valid position pairs
and the images synthesized on the device, bitwise; a LOCKSTEP trajectory
of ``DoubleCircleSquare-v0`` with injected reset draws (states and dones
bitwise, glimpses and rewards within 1e-6, the classification tier); and
the rounding sites of the synthesis."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apx
from apx.data.circle_square import DoubleCircleSquareDataset as JaxDCS
from apx.data.circle_square import double_circle_square_positions as jax_positions

import apx_torch
from apx_torch.convert import double_circle_square_from_numpy
from apx_torch.core.numerics import sqrt
from apx_torch.data import circle_square as cs
from apx_torch.data.circle_square import DoubleCircleSquareDataset, double_circle_square_positions

torch.set_num_threads(1)
TOL = 1e-6


@pytest.mark.parametrize("size", [28, 20, 15])
def test_positions_bitwise_equal_to_apx(size):
    ours = double_circle_square_positions((size, size))
    ref = jax_positions((size, size))
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    ds = DoubleCircleSquareDataset.create((size, size), device="cpu")
    assert ds.length == 4 * len(ref) and ds.num_classes == 3 and ds.image_shape == (size, size, 1)


def _indices(length: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    return np.concatenate([[0, 1, 2, 3, length - 1], rng.integers(0, length, 4096)])


@pytest.fixture(scope="module", params=[(28, True), (28, False), (15, True)],
                ids=["28-grad", "28-nograd", "15-grad"])
def apx_fetch(request):
    size, grad = request.param
    ref = JaxDCS.create((size, size), show_gradient_a=grad, show_gradient_b=grad)
    idx = _indices(ref.length)
    images, labels = jax.jit(jax.vmap(ref.fetch))(jnp.asarray(idx, jnp.int32))
    return ref, idx, np.asarray(images), np.asarray(labels).astype(np.int64)


def _ours(ref):
    return DoubleCircleSquareDataset.create(ref.image_hw, ref.object_extents, ref.show_gradient_a,
                                            ref.show_gradient_b, device="cpu")


def test_fetch_bitwise_equal_to_apx(apx_fetch):
    ref, idx, images, labels = apx_fetch
    ours = _ours(ref)
    img, lab = ours.fetch_raw(torch.from_numpy(idx))
    assert img.dtype == torch.float32 and img.shape == images.shape
    np.testing.assert_array_equal(img.numpy().view(np.int32), images.view(np.int32))
    np.testing.assert_array_equal(lab.numpy(), labels)
    assert set(np.unique(labels)) == {0, 1, 2}
    conv = double_circle_square_from_numpy(np.asarray(ref.positions), ref.image_hw,
                                           ref.object_extents, ref.show_gradient_a,
                                           ref.show_gradient_b, device="cpu")
    assert torch.equal(conv.fetch_raw(torch.from_numpy(idx[:64]))[0], img[:64])


def _division(nearest, max_dist):
    return 1.0 - nearest / torch.tensor(np.float32(max_dist))


def _reciprocal_unfused(nearest, max_dist):
    return 1.0 - nearest * float(np.float32(1.0) / np.float32(max_dist))


def _distance_contracted(dr, dc):
    from apx_torch.core.numerics import fma

    return sqrt(fma(dc, dc, dr * dr))


def _distance_float32_root(dr, dc):
    return torch.sqrt(dr * dr + dc * dc)


# site -> (helper, replacement, whether the images change)
_SITES = {
    "gradient fma(-min, 1/max, 1) -> 1 - min / max": ("_gradient", _division, True),
    "gradient fma -> 1 - min * (1/max)": ("_gradient", _reciprocal_unfused, True),
    # Integer offsets: the sum is exact and the root correctly rounded
    # either way, so these forms give apx's bytes too.
    "distance unfused -> contracted": ("_distance", _distance_contracted, False),
    "distance root in float64 -> float32": ("_distance", _distance_float32_root, False),
}


@pytest.mark.parametrize("site", ["as written", *_SITES])
def test_double_circle_square_rounding_sites(apx_fetch, monkeypatch, site):
    """The synthesis equals apx's jitted fetch bitwise; the gradient written
    any other way differs. The distance forms that cannot differ are held
    equal, so a change there is seen too."""
    ref, idx, images, _ = apx_fetch
    differs = False
    if site != "as written":
        name, fn, differs = _SITES[site]
        monkeypatch.setattr(cs, name, fn)
    img, _ = _ours(ref).fetch_raw(torch.from_numpy(idx))
    same = np.array_equal(img.numpy().view(np.int32), images.view(np.int32))
    if differs and not ref.show_gradient_a:
        differs = False  # without the gradient every pixel is 1 - 0 = 1 in any form
    assert same != differs


def _draw_fn(params, n):
    def one(key):
        k_idx, _, k_pos = jax.random.split(key, 3)
        idx = jax.random.randint(k_idx, (), 0, params.dataset.length, dtype=jnp.int32)
        return idx, jax.random.uniform(k_pos, (2,), minval=-1.0, maxval=1.0)

    batched = jax.jit(jax.vmap(one))

    def draws(keys):
        idx, pos = batched(keys)
        return {"index": torch.from_numpy(np.array(idx, dtype=np.int64)),
                "inverted": torch.zeros(n, dtype=torch.bool), "pos": torch.from_numpy(np.array(pos))}

    return draws


def _close(a, b, what):
    err = np.abs(np.asarray(a, dtype=np.float64) - b.numpy()).max()
    assert err <= TOL, f"{what}: max |diff| {err}"


@pytest.mark.parametrize("env_id", ["DoubleCircleSquare-v0", "DoubleCircleSquare-s15-nograd-v0"])
def test_lockstep_trajectory_matches_apx(env_id):
    n = 16
    jvenv, jp = apx.make_vec(env_id, num_envs=n)
    venv, p = apx_torch.make_vec(env_id, n, device="cpu")
    key = jax.random.PRNGKey(4)
    draws = _draw_fn(jp, n)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    obs, s, _ = venv.reset(p, draws=draws(jax.random.split(key, n)))
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(2)
    resets = 0
    for t in range(2 * (p.step_limit + 1)):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        logits = rng.standard_normal((n, 3)).astype(np.float32)
        jobs, js, jr, jte, jtr, _ = step(
            kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(logits)}, jp)
        obs, s, r, te, tr, _ = venv.step(
            s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(logits)}, p,
            reset_draws=draws(jax.random.split(jax.random.split(kt)[1], n)))
        what = f"{env_id} step {t}"
        _close(jobs["glimpse"], obs["glimpse"], f"{what} glimpse")
        for k in ("glimpse_pos", "time_step"):
            np.testing.assert_array_equal(np.asarray(jobs[k]), obs[k].numpy(), err_msg=what)
        ji, ti = js.inner, s.inner
        np.testing.assert_array_equal(np.asarray(ji.image), ti.image.numpy(), err_msg=what)
        np.testing.assert_array_equal(np.asarray(ji.label).astype(np.int64), ti.label.numpy())
        np.testing.assert_array_equal(np.asarray(ji.data_index).astype(np.int64),
                                      ti.data_index.numpy())
        np.testing.assert_array_equal(np.asarray(jte), te.numpy(), err_msg=what)
        _close(jr, r, f"{what} reward")
        resets += int((ti.time == 0).all())
    assert resets == 2
