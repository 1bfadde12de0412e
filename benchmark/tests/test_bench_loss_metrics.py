"""The readers of the vector env's loss (``yardstick/loss.py``):
``loss_us_per_step.rollout`` and ``cross_entropy_roofline`` on a synthetic
trace of two graph replays and its capture layout, and the cross-entropy's
bytes at the cell's shapes."""

import pytest

from apx_torch.core import trace as spans
from apx_torch.ops._launch import KERNELS

from benchmark import manifest
from benchmark.yardstick import loss, peaks

STEP = ("apx.vector.step",)
LOSS = STEP + ("apx.vector.loss",)
# node 0: the step's M; 1: the merge's copy; 2-3: the loss (its N1 last);
# 4: the harness's accumulator.
LAYOUT = {"capture": 1, "nodes": 5, "spans": [
    (STEP + ("apx.env.step", "apx.kernel.M"), 0, 1),
    (STEP + ("apx.env.step",), 0, 1),
    (LOSS + ("apx.kernel.N1",), 3, 4),
    (LOSS, 2, 4),
    (STEP, 0, 4),
]}
NODES = [("apx_image_move(...)", 2.0), ("memcpy128", 1.0), ("log_softmax_kernel", 6.0),
         ("apx_fma_f32(...)", 1.5), ("vectorized_elementwise_kernel", 2.0)]


def _trace(names=None):
    events, t = [], 0.0
    for corr in (100, 200):  # two replays
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": t,
                       "dur": 3.0, "args": {"correlation": corr}})
        for k, (name, dur) in enumerate(NODES):
            events.append({"ph": "X", "cat": "kernel", "name": (names or {}).get(k, name),
                           "ts": t + 10 * k + 5, "dur": dur,
                           "args": {"correlation": corr, "graph node id": 1000 + k}})
        t += 1000
    return {"traceEvents": events}


@pytest.fixture
def layouts(monkeypatch):
    """``layouts(layout)``: the program's capture layouts are [layout]."""
    def use(layout):
        monkeypatch.setattr(spans, "layouts", lambda: [] if layout is None else [layout])
    return use


def test_span_time_through_the_layout():
    assert loss.span_us(_trace(), LAYOUT, spans.owners, KERNELS) == 2 * (6.0 + 1.5)


def test_span_time_reads_nothing_where_the_layout_disagrees():
    args = (spans.owners, KERNELS)
    assert loss.span_us(_trace(), {**LAYOUT, "nodes": 6}, *args) is None  # another total
    assert loss.span_us(_trace({3: "other_kernel"}), LAYOUT, *args) is None  # N1's node
    assert loss.span_us({"traceEvents": []}, LAYOUT, *args) is None  # no replay
    without = {**LAYOUT, "spans": [s for s in LAYOUT["spans"] if "apx.vector.loss" not in s[0]]}
    assert loss.span_us(_trace(), without, *args) is None  # a program without the span


def test_loss_us_per_step_reader(layouts):
    reader = manifest.metric_reader("loss_us_per_step.rollout")
    ctx = {"trace": _trace(), "steps": 3, "least_s": {}}
    layouts(LAYOUT)
    assert reader.read(ctx) == pytest.approx(15.0 / 3)
    layouts({**LAYOUT, "nodes": 4})
    assert reader.read(ctx) is None
    layouts(None)
    assert reader.read(ctx) is None


def test_cross_entropy_roofline_reader(layouts):
    reader = manifest.metric_reader("cross_entropy_roofline")
    least = loss.cross_entropy_least_s(16384, 200)
    ctx = {"trace": _trace(), "steps": 3, "least_s": {"cross_entropy": least}}
    layouts(LAYOUT)
    assert reader.read(ctx) == pytest.approx(100.0 * least / 5e-6)
    assert reader.read({**ctx, "least_s": {}}) is None  # no cross-entropy in the cell
    without = {**LAYOUT, "spans": [s for s in LAYOUT["spans"] if "apx.vector.loss" not in s[0]]}
    layouts(without)
    assert reader.read(ctx) is None


def test_cross_entropy_bytes_at_the_cell():
    """N=16384 envs, 200 classes: 13.43 MB a vector step, 4.01 us at the
    HBM rate."""
    assert loss.cross_entropy_bytes(16384, 200) == 16384 * (200 * 4 + 8 + 4 + 4 + 4) == \
        13_434_880
    assert loss.cross_entropy_least_s(16384, 200) == pytest.approx(
        13_434_880 / peaks.HBM_BYTES_PER_S)
    assert 4.0e-6 < loss.cross_entropy_least_s(16384, 200) < 4.02e-6
