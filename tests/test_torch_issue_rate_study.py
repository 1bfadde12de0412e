"""The issue-rate study's chain: the port's plain form against apx's
``_chain_body`` and apx's Pallas kernel in interpret mode, bitwise, as
apx's own ``tests/test_lidar.py::test_issue_rate_study_kernels`` holds its
kernel; and K4's wrapper on the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apx.ops.issue_rate_study import CHAIN_OPS_PER_ELEM as JAX_OPS
from apx.ops.issue_rate_study import _chain_body, chain_pallas

from apx_torch.ops import issue_rate_study as study
from apx_torch.ops._launch import launched

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
    before = launched("K4")
    for layout in ("wide", "narrow"):
        assert torch.equal(study.chain_cuda(*args, iters=3, layout=layout),
                           study.chain_body(*args, 3))
    assert launched("K4") == before  # the plain form launches nothing
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


_SASS = """
        Function : _ZN12_GLOBAL__N_112chain_kernelILb1EEEvPKfS2_S2_S2_S2_Pfiii
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/                   MOV R2, 0x3e800000 ;                    /* 0x0 */
.L_x_0:
        /*0020*/                   FMNMX R5, R2, R3, !PT ;                 /* 0x0 */
        /*0030*/                   FSETP.GT.AND P0, PT, R4, R2, PT ;       /* 0x0 */
        /*0040*/                   FSEL R6, R5, R7, P0 ;                   /* 0x0 */
        /*0050*/                   FFMA R2, R6, 0.25, 0.125 ;              /* 0x0 */
        /*0060*/                   FMNMX R5, R2, R3, !PT ;                 /* 0x0 */
        /*0070*/                   FADD R8, R8, R6 ;                       /* 0x0 */
        /*0080*/                   FFMA R2, R6, 0.25, 0.125 ;              /* 0x0 */
        /*0090*/                   IADD3 R9, R9, 0x2, RZ ;                 /* 0x0 */
        /*00a0*/                   ISETP.GE.AND P1, PT, R9, R10, PT ;      /* 0x0 */
        /*00b0*/              @!P1 BRA `(.L_x_0) ;                         /* 0x0 */
.L_x_1:
        /*00c0*/                   FFMA R2, R6, 0.25, 0.125 ;              /* 0x0 */
        /*00d0*/               @P2 BRA 0xc0 ;                              /* 0x0 */
        /*00e0*/                   EXIT ;                                  /* 0x0 */
        ..........

        Function : _ZN12_GLOBAL__N_112chain_kernelILb0EEEvPKfS2_S2_S2_S2_Pfiii
        /*0000*/                   FMUL R3, R2, 0.5 ;                      /* 0x0 */
        /*0010*/                   FFMA R2, R6, 0.25, 0.125 ;              /* 0x0 */
        /*0020*/                   PLOP3.LUT P0, PT, P0, P1, PT, 0x80, 0x0 ;  /* 0x0 */
        /*0030*/               @P0 BRA 0x0 ;                               /* 0x0 */
        /*0040*/                   BRA 0x40;                               /* 0x0 */
        Function : _ZN12_GLOBAL__N_112window_kernelILi16ELb1EEEvPKhPK4int2Phiiiii
        /*0000*/                   EXIT ;                                  /* 0x0 */
"""


def test_sass_loop_counts_reads_the_main_loop():
    """The SASS reader picks each chain kernel's loop with the most FFMA
    (labels or addresses as branch targets) and counts per FFMA."""
    got = study.sass_loop_counts(_SASS)
    assert set(got) == {"wide", "narrow"}
    narrow = got["narrow"]
    assert narrow["loop_instructions"] == 10 and narrow["chain_iterations_per_loop_trip"] == 2
    assert narrow["per_iteration"] == {"add/mul/fma": 1.5, "compare": 0.5, "loop control": 1.5,
                                       "min/max": 1.0, "select": 0.5}
    assert narrow["instructions_per_iteration"] == 5.0
    assert narrow["opcodes_per_iteration"]["FFMA"] == 1.0
    wide = got["wide"]
    assert wide["loop_instructions"] == 4 and wide["chain_iterations_per_loop_trip"] == 1
    assert wide["per_iteration"] == {"add/mul/fma": 2.0, "loop control": 1.0,
                                     "predicate logic": 1.0}
    with pytest.raises(ValueError, match="no loop"):
        study.sass_loop_counts(_SASS.split("Function : _ZN12_GLOBAL__N_112chain_kernelILb0E")[0]
                               .replace("BRA", "EXIT"))


def test_sass_flag_reads_a_dump_without_the_card(tmp_path, capsys):
    """``--sass FILE`` prints the counts of a saved ``cuobjdump -sass`` dump
    and measures nothing."""
    dump = tmp_path / "kernels.sass"
    dump.write_text(_SASS)
    study.main(["--sass", str(dump)])
    got = json.loads(capsys.readouterr().out)
    assert got["ops_priced_per_iteration"] == study.CHAIN_OPS_PER_ELEM
    assert got["narrow"] == study.sass_loop_counts(_SASS)["narrow"]
