"""The port's glimpse (K3's plain form and its wrapper) and geometry, held
against the JAX package on the CPU.

The plain form is held to apx's ``extract_glimpse_batch`` at
``precision="highest"`` and to the Pallas kernel itself
(``glimpse_batch_lane_major``, interpret mode) within 1e-6 absolute, apx's
own tolerance for K3; coordinates and positions are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apx.ops.geometry import project_sphere as jax_project_sphere
from apx.ops.glimpse import extract_glimpse_batch as jax_glimpse
from apx.ops.glimpse import glimpse_coords as jax_coords
from apx.ops.glimpse_pallas import glimpse_batch_lane_major

from apx_torch.core.numerics import fma
from apx_torch.ops import build, glimpse_cuda
from apx_torch.ops._launch import launched
from apx_torch.ops.geometry import project_sphere
from apx_torch.ops.glimpse import extract_glimpse_batch, glimpse_coords, interp_weights

torch.set_num_threads(1)
TOL = 1e-6
EDGES = [[1, 1], [-1, -1], [1, -1], [-1, 1], [0, 1], [1, 0], [-1, 0], [0, -1],
         [1, 0.37], [-0.81, -1]]
GEOMETRIES = [((28, 28, 1), (5, 5), 1.0), ((64, 64, 3), (10, 10), 1.0),
              ((33, 47, 3), (4, 7), 2.5)]


def _inputs(shape, dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        images = rng.integers(0, 256, (n, *shape), dtype=np.uint8)
    else:
        images = rng.random((n, *shape)).astype(np.float32)
    pos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    k = min(n, len(EDGES))
    pos[:k] = EDGES[:k]  # the clip to the image decides at the edges
    return images, pos


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shape,sensor,scale", GEOMETRIES)
def test_plain_glimpse_matches_apx(shape, sensor, scale, dtype):
    images, pos = _inputs(shape, dtype, 96, seed=shape[0] + sensor[1])
    ref = np.asarray(jax_glimpse(jnp.asarray(images), jnp.asarray(pos), sensor, scale,
                                 precision="highest"))
    got = extract_glimpse_batch(torch.from_numpy(images), torch.from_numpy(pos), sensor, scale)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= TOL
    assert got.min() >= 0 and got.max() <= 1
    # The wrapper runs the plain form for a CPU tensor and launches nothing.
    before = launched("K3")
    wrapped = glimpse_cuda.glimpse(torch.from_numpy(images), torch.from_numpy(pos), sensor, scale)
    assert torch.equal(wrapped, got) and launched("K3") == before


@pytest.mark.parametrize("shape,sensor,scale", GEOMETRIES)
def test_coordinates_bitwise_equal_to_apx(shape, sensor, scale):
    """The centre pixel is an FMA in apx's jitted glimpse; the port's
    coordinates (and so its hat weights) are apx's bits."""
    _, pos = _inputs(shape, "float32", 200, seed=1)
    jr, jc = jax.jit(jax.vmap(lambda p: jax_coords(p, shape[:2], sensor, scale)))(jnp.asarray(pos))
    rows, cols = glimpse_coords(torch.from_numpy(pos), shape[:2], sensor, scale)
    np.testing.assert_array_equal(np.asarray(jr), rows.numpy())
    np.testing.assert_array_equal(np.asarray(jc), cols.numpy())


def test_plain_glimpse_matches_pallas_kernel():
    """Against K3 itself, run as apx's tests run it on the CPU (interpret
    mode), at apx's own test shape (tests/test_glimpse.py)."""
    images, pos = _inputs((32, 32, 3), "uint8", 128, seed=5)
    ref = glimpse_batch_lane_major(jnp.asarray(images), jnp.asarray(pos), (5, 5), 1.0,
                                   interpret=True)
    got = extract_glimpse_batch(torch.from_numpy(images), torch.from_numpy(pos), (5, 5), 1.0)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL


def test_interp_weights_are_two_tap_hats():
    c = torch.tensor([0.0, 0.25, 3.0, 6.5, 7.0, -2.0, 9.5])
    w = interp_weights(c, 8)
    assert w.shape == (7, 8) and torch.all((w > 0).sum(-1) <= 2)
    assert torch.allclose(w.sum(-1), torch.ones(7))
    assert w[5, 0] == 1 and w[6, 7] == 1  # clipped into the image
    assert w[1, 0] == 0.75 and w[1, 1] == 0.25


def test_uint8_conversion_is_division_by_255():
    """K3 converts a uint8 pixel x as q = RN(x r), RN(q + RN(x - 255 q) r)
    with r = RN(1/255), each FMA rounded once (``pixel`` in
    apx_torch/csrc/glimpse.cu). Over all 256 values that is the correctly
    rounded x / 255, i.e. torch.arange(256) / 255 bitwise, numpy's and the
    plain form's bits; the product x r alone is not. A 1x1 sensor on a 1x1
    image returns the converted pixel."""
    x = torch.arange(256, dtype=torch.float32)
    table = x / 255
    np.testing.assert_array_equal(table.numpy(),
                                  np.arange(256, dtype=np.float32) / np.float32(255))
    r = torch.full((256,), float.fromhex("0x1.010102p-8"), dtype=torch.float32)
    assert r[0] == torch.tensor(1.0) / 255
    q = x * r
    assert not torch.equal(q, table)
    assert torch.equal(fma(fma(-q, torch.full_like(q, 255.0), x), r, q), table)
    images = torch.arange(256, dtype=torch.uint8).reshape(256, 1, 1, 1)
    got = glimpse_cuda.glimpse(images, torch.zeros((256, 2)), (1, 1))
    assert torch.equal(got.reshape(256), table)


def test_unported_window_raises():
    """apx's ``window="rows"`` is accepted: bitwise ``"off"`` (the row band
    leaves out only rows of hat weight 0); an unknown window raises."""
    images, pos = _inputs((28, 28, 1), "float32", 4, seed=0)
    args = (torch.from_numpy(images), torch.from_numpy(pos), (5, 5))
    assert torch.equal(extract_glimpse_batch(*args, window="rows"),
                       extract_glimpse_batch(*args, window="off"))
    with pytest.raises(ValueError, match="window"):
        extract_glimpse_batch(*args, window="cols")


def test_wrapper_rejects_bad_input():
    img = torch.zeros((4, 8, 8, 1))
    with pytest.raises(ValueError):
        glimpse_cuda.glimpse(img, torch.zeros((3, 2)), (3, 3))
    with pytest.raises(TypeError):
        glimpse_cuda.glimpse(img.double(), torch.zeros((4, 2)), (3, 3))
    with pytest.raises(ValueError):
        glimpse_cuda.glimpse(img[0], torch.zeros((4, 2)), (3, 3))


def test_wrapper_does_not_fall_back_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel, never to the plain
    form: here the kernel library cannot be had, and the call raises."""
    def no_library():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(build, "load", no_library)
    images = torch.zeros((4, 8, 8, 1), device="meta")
    with pytest.raises(RuntimeError, match="no kernel library"):
        glimpse_cuda.glimpse(images, torch.zeros((4, 2), device="meta"), (3, 3))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_project_sphere_bitwise_equal_to_apx(scale):
    rng = np.random.default_rng(7)
    x = (rng.uniform(-1.6, 1.6, (4000, 2)) * scale).astype(np.float32)
    x[:4] = [[0, 0], [1, 0], [0.6, 0.8], [-3, 4]]
    ref = jax.jit(jax_project_sphere)(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ref), project_sphere(torch.from_numpy(x)).numpy())
