"""The port's glimpse study (apx_torch.ops.glimpse_study) and the plain
form's ``precision`` argument, on the CPU: ``tap2_glimpse`` against apx's
within 2e-5, ``precision="highest"`` and the default (``None``: the
caller's TF32 setting) bitwise the products as the plain form computed
them before the argument existed, and the
study's functions at a tiny size (nothing timed off the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apx.ops import glimpse_study as apx_study
from apx_torch.core.numerics import div, matmul_tf32
from apx_torch.ops import glimpse_study as study
from apx_torch.ops.glimpse import (PRECISIONS, extract_glimpse_batch, glimpse_coords,
                                   interp_weights)

torch.set_num_threads(1)
EDGES = [[1, 1], [-1, -1], [1, -1], [-1, 1], [0, 1], [1, 0.37], [-0.81, -1]]


def _inputs(n, h, w, c, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        images = rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
    else:
        images = rng.random((n, h, w, c)).astype(np.float32)
    pos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    k = min(n, len(EDGES))
    pos[:k] = EDGES[:k]
    return images, pos


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_tap2_matches_apx(dtype):
    """apx's tap2 (per image, vmapped and jitted) at the study's geometry,
    positions including the corners and edges where the taps clip."""
    images, pos = _inputs(24, 64, 64, 3, seed=5, dtype=dtype)
    want = np.asarray(jax.jit(jax.vmap(apx_study.tap2_glimpse))(jnp.asarray(images),
                                                                jnp.asarray(pos)))
    got = study.tap2_glimpse(torch.as_tensor(images), torch.as_tensor(pos)).numpy()
    assert got.shape == want.shape == (24, 10, 10, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def _products_before_precision(images, pos, sensor, scale):
    """The plain form's body as it stood before ``precision``."""
    _, h, w, _ = images.shape
    rows, cols = glimpse_coords(pos, (h, w), sensor, scale)
    img = images.to(torch.float32)
    if images.dtype == torch.uint8:
        img = div(img, 255.0)
    tmp = torch.einsum("nsh,nhwc->nswc", interp_weights(rows, h), img)
    return torch.einsum("nswc,ntw->nstc", tmp, interp_weights(cols, w)).clamp(0.0, 1.0)


@pytest.mark.parametrize("shape,sensor,scale", [((28, 28, 1), (5, 5), 1.0),
                                                ((64, 64, 3), (10, 10), 1.0),
                                                ((33, 47, 3), (4, 7), 2.5)])
def test_precision_highest_is_the_default_bitwise(shape, sensor, scale):
    for dtype in (np.uint8, np.float32):
        images, pos = _inputs(16, *shape, seed=shape[0], dtype=dtype)
        images, pos = torch.as_tensor(images), torch.as_tensor(pos)
        before = _products_before_precision(images, pos, sensor, scale)
        default = extract_glimpse_batch(images, pos, sensor, scale)
        highest = extract_glimpse_batch(images, pos, sensor, scale, precision="highest")
        assert torch.equal(default, before) and torch.equal(highest, before)
        # TF32 is a setting of the card's products: the CPU's are float32.
        assert torch.equal(extract_glimpse_batch(images, pos, sensor, scale, precision="high"),
                           before)
        bf16 = extract_glimpse_batch(images, pos, sensor, scale, precision="default")
        assert bf16.dtype == torch.float32
        assert 0 < float((bf16 - before).abs().max()) < 2e-2
    assert not torch.backends.cuda.matmul.allow_tf32  # restored
    with pytest.raises(ValueError, match="precision"):
        extract_glimpse_batch(images, pos, sensor, scale, precision="fastest")
    assert PRECISIONS == ("highest", "high", "default")


def test_precision_leaves_the_global_tf32_setting_as_it_was():
    """The default reads the caller's TF32 setting and does not touch it;
    a named precision sets it for its products only (``matmul_tf32``)."""
    images, pos = map(torch.as_tensor, _inputs(4, 20, 24, 3, seed=5))
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    try:
        for setting in (True, False):
            matmul.allow_tf32 = setting
            for precision in (None, *PRECISIONS):
                extract_glimpse_batch(images, pos, (4, 5), precision=precision)
                assert matmul.allow_tf32 is setting, (setting, precision)
            with matmul_tf32(not setting):
                assert matmul.allow_tf32 is (not setting)
            assert matmul.allow_tf32 is setting
    finally:
        matmul.allow_tf32 = prev


def test_study_runs_small_on_the_cpu():
    """Every variant at N=8 on a 20x24x3 bank with a 4x5 sensor: errors
    against the float64 oracle as each precision allows, K3 (its plain form
    on the CPU) and tap2 within the study's 1e-5, nothing timed."""
    res = study.run_study("cpu", n=8, hw=(20, 24), c=3, sensor_size=(4, 5), reps=2,
                          gather_rows=50, gather_bytes=16)
    assert list(res["variants"]) == ["k3[u8]", "k3[f32]", "gemm[highest]", "gemm[high]",
                                     "gemm[default]", "gemm[highest, f32 bank]", "tap2[u8]",
                                     "grid_sample[f32]"]
    for name, v in res["variants"].items():
        assert v["us_per_batch"] is v["moving_us_per_batch"] is v["alone_us_per_batch"] is None
        limit = 2e-2 if name == "gemm[default]" else 1e-5
        assert v["max_abs_err_vs_f64"] < limit, (name, v)
    assert res["variants"]["k3[u8]"]["max_abs_err_vs_fp32_plain"] == 0.0
    assert res["row_gather"] == {"rows": 50, "gathered_per_step": 8, "same_bytes": True,
                                 "u8_us": None, "i32_us": None}
    assert res["k3_launches"] == 0  # the CPU runs the plain form, launching nothing


def test_study_chain_and_oracle():
    """The chain moves positions by the glimpse's first values (apx's scan
    body) and stays in [-1, 1]; the oracle is the plain form in float64."""
    images, pos = _inputs(4, 16, 16, 1, seed=3)
    images, pos = torch.as_tensor(images), torch.as_tensor(pos)
    final = study._chain(lambda b, p: study.tap2_glimpse(b, p, (3, 3)), images, pos, 5)
    assert final.shape == pos.shape and float(final.abs().max()) <= 1.0
    assert not torch.equal(final, pos)
    oracle = study.oracle_glimpse(images, pos, (3, 3))
    assert oracle.dtype == torch.float64
    plain = extract_glimpse_batch(images, pos, (3, 3))
    np.testing.assert_allclose(plain.numpy(), oracle.numpy(), rtol=0, atol=1e-6)
    assert study.chain_us(lambda b, p: study.tap2_glimpse(b, p, (3, 3)), images, pos, 2) is None
    # The moving chain: each step moves each axis by +-MOVE, wrapped into [-1, 1).
    const = torch.full((4, 3, 3, 1), 0.75)
    moved = study._chain(lambda b, p: const, images, pos, 3, study.MOVE)
    want = torch.remainder(pos.double() + 3 * study.MOVE + 1.0, 2.0) - 1.0
    np.testing.assert_allclose(moved.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert float(moved.min()) >= -1.0 and float(moved.max()) < 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            study.main([])
