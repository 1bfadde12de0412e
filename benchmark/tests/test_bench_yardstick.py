"""The frozen yardstick: the trace arithmetic, the peaks, the least-time
arithmetic and the import guard."""

import subprocess
import sys

import pytest
import torch

from benchmark.yardstick import bounds, guard, peaks, trace


def _trace(device, host=()):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d} for n, ts, d in device]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": ts, "dur": d} for n, ts, d in host]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "ts": 0, "dur": 1e6}]
    return {"traceEvents": ev}


def test_busy_is_the_union_of_device_intervals():
    t = _trace([("a", 0, 10), ("b", 5, 10), ("c", 30, 5)])
    assert trace.busy_us(t) == 20.0
    assert len(trace.device_events(t)) == 3


def test_idle_gaps_name_the_host_event_and_skip_profiler_steps():
    t = _trace([("a", 0, 10), ("b", 30, 5), ("c", 40, 5)],
               host=[("cudaGraphLaunch", 8, 25), ("cudaMemcpyAsync", 36, 2)])
    gaps = trace.idle_gaps(t)
    assert gaps[0] == ("cudaGraphLaunch", 20.0)
    assert gaps[1] == ("cudaMemcpyAsync", 5.0)


def test_top_ops_and_matching():
    t = _trace([("glimpse_kernel<u8>", 0, 10), ("copy", 10, 3), ("glimpse_kernel<u8>", 20, 4)])
    assert trace.top_ops(t) == [("glimpse_kernel<u8>", 14.0), ("copy", 3.0)]
    assert trace.matching_us(t, ("glimpse_kernel",)) == 14.0


def test_no_device_events_raises():
    with pytest.raises(ValueError):
        trace.busy_us(_trace([]))


def test_peaks():
    assert peaks.HBM_BYTES_PER_S == 3.35e12 and peaks.FP32_OPS_PER_S == 67e12
    assert peaks.FP32_ISSUE_PER_S == 33.5e12


@pytest.mark.parametrize("n,h,w,beams,per_env", [(16384, 32, 32, 8, 224), (1, 21, 21, 8, 152),
                                                 (4096, 32, 32, 1, 196)])
def test_lidar_step_bytes(n, h, w, beams, per_env):
    # The map at one bit a cell: 128 B for 32x32, 56 for 21x21 (441 bits).
    assert bounds.lidar_step_bytes(n, h, w, beams) == n * per_env


def test_candidate_cells():
    # A horizontal segment from the middle of cell (2, 3) one cell to the
    # right passes columns 2 and 3 of row 3.
    o = torch.tensor([[2.5, 3.5]])
    assert bounds.candidate_cells(8, 8, o, o[:, None, :] + torch.tensor([[[1.0, 0.0]]])) == 2
    # A diagonal from the centre of (0, 0) to that of (2, 2): a 3x3 hull.
    o = torch.tensor([[0.5, 0.5]])
    assert bounds.candidate_cells(8, 8, o, torch.tensor([[[2.5, 2.5]]])) == 9


def test_lidar_step_least_time_is_bytes_bound_at_the_cell():
    n = 16384
    least = bounds.lidar_step_least_s(n, 32, 32, 8, cells=160 * n)
    assert least == pytest.approx(n * 224 / peaks.HBM_BYTES_PER_S)
    # A kernel that takes exactly the least time reads 100%, whatever its layout.
    assert 100.0 * least / least == 100.0


def test_glimpse_footprint_and_bytes():
    # Centred, the samples fall on pixels 27..36 exactly: 10 rows, 10 columns;
    # a little off, each sample spans two pixels: 11 by 11.
    centre = torch.zeros((1, 2))
    assert bounds.glimpse_footprint(centre, (64, 64), (10, 10)).tolist() == [100]
    pos = torch.full((4, 2), 0.01)
    assert bounds.glimpse_footprint(pos, (64, 64), (10, 10)).tolist() == [121] * 4
    assert bounds.glimpse_bytes(pos, (64, 64, 3), (10, 10)) == 4 * (121 * 3 + 8 + 1200)
    assert bounds.glimpse_least_s(pos, (64, 64, 3), (10, 10)) == pytest.approx(
        4 * 1571 / peaks.HBM_BYTES_PER_S)


def test_guard_compares_top_level_names_whole():
    assert guard.forbidden_loaded({"apx_torch": 1, "apx_torch.core": 1, "numpy": 1}) == []
    assert guard.forbidden_loaded({"apx.core": 1, "jax": 1, "jaxlib.xla": 1, "flax": 1}) == \
        ["apx.core", "flax", "jax", "jaxlib.xla"]


def test_a_run_loads_no_jax_and_the_reference_no_port():
    code = ("import sys; import benchmark.run, benchmark.control, benchmark.kinds.rollout; "
            "import benchmark.families.lidar, benchmark.families.image_loc; "
            "from benchmark.yardstick import guard; print(guard.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(guard.__file__).rsplit("/benchmark/", 1)[0])
    assert out.stdout.strip() == "[]"
    code = ("import sys; import benchmark.reference.lidar, benchmark.reference.image_loc; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'apx_torch', 'apx', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(guard.__file__).rsplit("/benchmark/", 1)[0])
    assert out.stdout.strip() == "[]"
