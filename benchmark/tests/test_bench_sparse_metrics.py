"""The readers of the ``-sparse`` losses and the classification metrics
(``yardstick/sparse.py``): ``sparse_loss_us_per_step.rollout``,
``sparse_loss_roofline``, ``metrics_us_per_step.rollout`` and
``classification_metrics_roofline`` on a synthetic trace of two graph
replays and its capture layout, and the bytes of each at the cell's
shapes."""

import pytest

from apx_torch.core import trace as spans
from apx_torch.ops._launch import KERNELS

from benchmark import manifest
from benchmark.yardstick import peaks, sparse

STEP = ("apx.vector.step",)
LOSS = STEP + ("apx.vector.loss",)
INFO = STEP + ("apx.vector.info_loss",)
METRICS = ("apx.vector.metrics",)
# node 0: the step's M; 1-2: the weighted loss (its P last); 3: the dense
# info loss; 4-5: the metrics; 6: the harness's accumulator.
LAYOUT = {"capture": 1, "nodes": 7, "spans": [
    (STEP + ("apx.env.step", "apx.kernel.M"), 0, 1),
    (STEP + ("apx.env.step",), 0, 1),
    (LOSS, 1, 3),
    (INFO, 3, 4),
    (STEP, 0, 4),
    (METRICS, 4, 6),
]}
NODES = [("apx_image_move(...)", 2.0), ("log_softmax_kernel", 6.0), ("mul_kernel", 1.5),
         ("log_softmax_kernel", 5.0), ("softmax_kernel", 4.0), ("reduce_kernel", 3.0),
         ("vectorized_elementwise_kernel", 2.0)]


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


def _without(name):
    return {**LAYOUT, "spans": [s for s in LAYOUT["spans"] if name not in s[0]]}


@pytest.fixture
def layouts(monkeypatch):
    """``layouts(layout)``: the program's capture layouts are [layout]."""
    def use(layout):
        monkeypatch.setattr(spans, "layouts", lambda: [] if layout is None else [layout])
    return use


def test_union_of_the_two_loss_spans():
    args = (spans.owners, KERNELS)
    assert sparse.union_us(_trace(), LAYOUT, *args) == 2 * (6.0 + 1.5 + 5.0)
    # A program without the info span (the parent's): the weighted loss alone.
    assert sparse.union_us(_trace(), _without("apx.vector.info_loss"), *args) == 2 * 7.5
    # Both losses under one span: the same nodes, the same time.
    one = {**LAYOUT, "spans": [s for s in LAYOUT["spans"] if s[0] not in (LOSS, INFO)]
           + [(LOSS, 1, 4)]}
    assert sparse.union_us(_trace(), one, *args) == 2 * 12.5


def test_union_reads_nothing_without_the_loss_span_or_where_the_layout_disagrees():
    args = (spans.owners, KERNELS)
    assert sparse.union_us(_trace(), _without("apx.vector.loss"), *args) is None
    assert sparse.union_us(_trace(), {**LAYOUT, "nodes": 8}, *args) is None  # another total
    assert sparse.union_us(_trace({0: "other_kernel"}), LAYOUT, *args) is None  # M's node
    assert sparse.union_us({"traceEvents": []}, LAYOUT, *args) is None  # no replay


def test_sparse_loss_us_per_step_reader(layouts):
    reader = manifest.metric_reader("sparse_loss_us_per_step.rollout")
    ctx = {"trace": _trace(), "steps": 5, "least_s": {}}
    layouts(LAYOUT)
    assert reader.read(ctx) == pytest.approx(25.0 / 5)
    layouts({**LAYOUT, "nodes": 6})
    assert reader.read(ctx) is None
    layouts(_without("apx.vector.loss"))
    assert reader.read(ctx) is None
    layouts(None)
    assert reader.read(ctx) is None


def test_metrics_us_per_step_reader(layouts):
    reader = manifest.metric_reader("metrics_us_per_step.rollout")
    ctx = {"trace": _trace(), "steps": 2, "least_s": {}}
    layouts(LAYOUT)
    assert reader.read(ctx) == pytest.approx(14.0 / 2)
    layouts(_without("apx.vector.metrics"))  # the parent's program
    assert reader.read(ctx) is None
    layouts({**LAYOUT, "nodes": 6})
    assert reader.read(ctx) is None


@pytest.mark.parametrize("name,key,span_us", [
    ("sparse_loss_roofline", "sparse_loss", 25.0),
    ("classification_metrics_roofline", "classification_metrics", 14.0)])
def test_rooflines(name, key, span_us, layouts):
    reader = manifest.metric_reader(name)
    least = {"sparse_loss": sparse.sparse_loss_least_s(16384, 200),
             "classification_metrics": sparse.classification_metrics_least_s(16384, 200, 16)}
    ctx = {"trace": _trace(), "steps": 1, "least_s": least}
    layouts(LAYOUT)
    assert reader.read(ctx) == pytest.approx(100.0 * least[key] / (span_us * 1e-6))
    assert reader.read({**ctx, "least_s": {}}) is None  # no such work in the cell
    layouts(_without("apx.vector.loss") if key == "sparse_loss" else
            _without("apx.vector.metrics"))
    assert reader.read(ctx) is None  # no span
    layouts(None)
    assert reader.read(ctx) is None


def test_sparse_loss_bytes_at_the_cells_shapes():
    """Logits 800, label 8, weight 4, base reward 4 read; weighted loss,
    reward and dense loss 4 each written: 828 bytes an env."""
    assert sparse.sparse_loss_bytes(16384, 200) == 13_565_952
    assert sparse.sparse_loss_least_s(16384, 200) == 13_565_952 / peaks.HBM_BYTES_PER_S
    assert sparse.sparse_loss_least_s(16384, 200) * 1e6 == pytest.approx(4.0495, abs=1e-4)


def test_classification_metrics_bytes_term_by_term():
    terms = sparse.classification_metrics_terms(200, 16)
    assert terms == {"logits": 800, "label": 8, "buffer_read": 64, "count_read": 4, "dones": 3,
                     "buffer_write": 64, "count_write": 4, "done_write": 1, "statistics": 24,
                     "masks": 9}
    assert sparse.classification_metrics_bytes(16384, 200, 16) == 16384 * 981
    assert sparse.classification_metrics_least_s(16384, 200, 16) * 1e6 == \
        pytest.approx(4.80, abs=0.01)
