"""The issue-rate study's chain: the port's plain form against apx's
``_chain_body`` and apx's Pallas kernel in interpret mode, bitwise, as
apx's own ``tests/test_lidar.py::test_issue_rate_study_kernels`` holds its
kernel; and K4's wrapper on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apx.ops.issue_rate_study import CHAIN_OPS_PER_ELEM as JAX_OPS
from apx.ops.issue_rate_study import _chain_body, chain_pallas

from apx_torch.ops import issue_rate_study as study

torch.set_num_threads(1)


def _inputs(rows, lanes, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((rows, lanes), dtype=np.float32) for _ in range(5)]


@pytest.mark.parametrize("lanes", [128, 16])
def test_chain_body_bitwise_equal_to_apx(lanes):
    args = _inputs(512, lanes, lanes)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(_chain_body(*jargs, 5))
    kernel = np.asarray(chain_pallas(*jargs, iters=5, block_rows=256, interpret=True))
    np.testing.assert_allclose(kernel, want, rtol=0, atol=0)
    got = study.chain_body(*(torch.from_numpy(a) for a in args), 5)
    assert got.dtype == torch.float32 and got.shape == (512, lanes)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), kernel, rtol=0, atol=0)


def test_chain_feedback_stays_bounded_and_bitwise():
    """``measure`` feeds each rep's output back in as nx; over a few
    chained reps the port still equals apx's chain bitwise."""
    args = _inputs(64, 16, 1)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    for _ in range(4):
        want = _chain_body(*jargs, 9)
        got = study.chain_body(*targs, 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jargs[0], targs[0] = want, got
    assert np.isfinite(got.numpy()).all() and got.abs().max() < 40


def test_chain_wrapper_on_cpu_and_its_checks():
    assert study.CHAIN_OPS_PER_ELEM == JAX_OPS == 16
    assert study.LANES == {"wide": 128, "narrow": 16}
    args = [torch.from_numpy(a) for a in _inputs(32, 16, 2)]
    before = study.LAUNCHES["chain"]
    for layout in ("wide", "narrow"):
        assert torch.equal(study.chain_cuda(*args, iters=3, layout=layout),
                           study.chain_body(*args, 3))
    assert study.LAUNCHES["chain"] == before  # the plain form launches nothing
    with pytest.raises(ValueError, match="layout"):
        study.chain_cuda(*args, iters=3, layout="diagonal")
    wide = [torch.zeros((4, 128)) for _ in range(5)]
    with pytest.raises(ValueError, match="lanes <= 32"):
        study.chain_cuda(*wide, iters=3, layout="narrow")
    with pytest.raises(TypeError):
        study.chain_cuda(*[a.double() for a in args], iters=3)
    with pytest.raises(ValueError):
        study.chain_cuda(*args[:4], torch.zeros((32, 8)), iters=3)


def test_measure_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.measure(rows=8, iters=1, reps=1)
