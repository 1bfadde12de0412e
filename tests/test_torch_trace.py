"""The port's span facility (``apx_torch.core.trace``), the spans at the
vector env's stages, the benchmark's reader of them through a capture
layout (``benchmark/yardstick/stages.py``) and ``parse_trace --spans``;
the facility's device counters and the benchmark's reader of R's; the
kernels' launch seam (``apx_torch.ops._launch``) with stand-in functions.

The CPU tests stub the capture (its query and its node counter). The card
test (marked ``cuda``, skipped without a device) captures a LIDAR chunk:

    python -m pytest --noconftest -o addopts="" tests/test_torch_trace.py -m cuda
"""

import ctypes
import importlib
import json
import pkgutil
import types

import numpy as np
import pytest
import torch

import apx_torch
from apx_torch.core import trace
from apx_torch.core.env import AutoResetMode, vector_env, with_autoreset
from apx_torch.ops import _launch
from apx_torch.tools import parse_trace
from benchmark import manifest
from benchmark.yardstick import stages


@pytest.fixture
def registry():
    trace.clear()
    yield
    trace.clear()


class FakeCapture:
    """A capture that the stubbed queries report: ``issue(k)`` adds k
    device nodes to its graph."""

    def __init__(self, cid=7):
        self.cid, self.nodes, self.active = cid, 0, True

    def issue(self, k=1):
        self.nodes += k

    def count(self):
        return self.cid, self.nodes


@pytest.fixture
def capture(monkeypatch, registry):
    cap = FakeCapture()
    monkeypatch.setattr(trace, "_OPEN", 1)
    monkeypatch.setattr(trace, "_capturing", lambda: cap.active)
    monkeypatch.setattr(trace, "_count_nodes", cap.count)
    return cap


@pytest.fixture
def stand_in(monkeypatch):
    """``make(fn, kernel="S")``: a new entry of ``kernel`` whose library
    function is the stand-in ``fn``, launching on stream handle 0; the
    launch table is restored after the test."""
    monkeypatch.setattr(_launch, "_TABLE", dict(_launch._TABLE))
    monkeypatch.setattr(_launch, "stream", lambda dev: 0)

    def make(fn, kernel="S", name="stand_in_launch"):
        launch = _launch.entry(kernel, name, [])
        launch.fn = fn
        return launch

    return make


def test_spans_nest_and_time_on_the_host():
    @trace.span("outer")
    def outer():
        with trace.span("inner"):
            sum(range(20000))
        with trace.span("inner"):
            pass
        return "done"

    with trace.timed() as times:
        assert outer() == "done"
    assert set(times.total) == {("apx.outer",), ("apx.outer", "apx.inner")}
    assert 0 < times.seconds("inner") < times.seconds("outer")
    assert outer.__name__ == "outer"
    assert trace._stack() == []


def test_inert_span_never_enters_record_function(monkeypatch, stand_in):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) off the profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with trace.span("a"):
        pass
    assert trace.span("b")(lambda x: x + 1)(1) == 2
    assert trace.call("c", max, 3, 4) == 4
    assert stand_in(lambda *a: 0)(torch.device("cpu"), 1, 2) is None
    assert trace._stack() == []


def test_span_under_the_profiler_annotates_the_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("vector.step"):
            trace.call("kernel.S", torch.ones(4).sum)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"apx.vector.step", "apx.kernel.S"} <= names
    rows = {name: (n, host) for name, n, host, _ in parse_trace.spans({"traceEvents": events})}
    assert rows["apx.vector.step"][0] == 1
    assert rows["apx.vector.step"][1] >= rows["apx.kernel.S"][1]


def test_capture_records_each_span_range(capture, stand_in):
    launch = stand_in(lambda stream: capture.issue() or 0)
    with trace.span("vector.step"):
        capture.issue(2)  # the merge's nodes before the step
        with trace.span("env.step"):
            launch(torch.device("cpu"))
        with trace.span("env.reset"):
            capture.issue(3)
        capture.issue(1)
    capture.issue(4)  # the harness, after the spans
    (layout,) = trace.layouts()
    assert layout["capture"] == 7 and layout["nodes"] is None
    assert layout["spans"] == [
        (("apx.vector.step", "apx.env.step", "apx.kernel.S"), 2, 3),
        (("apx.vector.step", "apx.env.step"), 2, 3),
        (("apx.vector.step", "apx.env.reset"), 3, 6),
        (("apx.vector.step",), 0, 7),
    ]
    step = ("apx.vector.step",)
    assert trace.owners(layout, 11) == [step, step, step + ("apx.env.step", "apx.kernel.S"),
                                        *[step + ("apx.env.reset",)] * 3, step, *[None] * 4]
    # A second capture gets its own layout, newest last; a span that ends
    # after its capture did records nothing.
    capture.cid, capture.nodes = 8, 0
    with trace.span("vector.reset"):
        capture.issue()
        capture.active = False
    assert [lay["capture"] for lay in trace.layouts()] == [7]
    capture.active = True
    with trace.span("vector.reset"):
        capture.issue()
    assert [lay["capture"] for lay in trace.layouts()] == [7, 8]
    trace.clear()
    assert trace.layouts() == []


def test_captures_are_followed_through_torch(capture, monkeypatch):
    class Graph:
        calls = []

        def capture_begin(self):
            Graph.calls.append("begin")

        def capture_end(self):
            Graph.calls.append("end")

    monkeypatch.setattr(trace, "_OPEN", 0)
    trace._watch_captures(Graph)
    graph = Graph()
    with trace.span("vector.step"):  # before the capture: inert
        capture.issue(3)
    assert trace.layouts() == []
    capture.nodes = 0
    graph.capture_begin()
    assert trace._OPEN == 1
    with trace.span("vector.step"):
        capture.issue(5)
    capture.issue(2)
    graph.capture_end()
    assert Graph.calls == ["begin", "end"] and trace._OPEN == 0
    (layout,) = trace.layouts()
    assert layout["nodes"] == 7 and layout["spans"] == [(("apx.vector.step",), 0, 5)]


def test_entry_counts_a_launch_under_its_id_and_entry(stand_in):
    calls = []
    launch = stand_in(lambda *args: calls.append(args) or 0)
    before = _launch.launched("S")
    launch(torch.device("cpu"), 1, None)
    assert calls == [(1, None, 0)]  # the stream handle last
    assert _launch.launches()["S.stand_in_launch"] == 1
    assert _launch.launched("S.stand_in_launch") == 1 and _launch.launched("S") == before + 1


def test_entry_raises_on_a_cuda_error_and_counts_nothing(stand_in):
    launch = stand_in(lambda *args: 98)
    with pytest.raises(RuntimeError, match=r"^S \(stand_in_launch\): .* CUDA error 98$"):
        launch(torch.device("cpu"), 1)
    assert _launch.launched("S.stand_in_launch") == 0


def test_entry_launches_inside_its_kernel_span(stand_in):
    launch = stand_in(lambda *args: 0, kernel="L")
    with trace.timed() as times:
        with trace.span("env.step"):
            launch(torch.device("cpu"))
    assert ("apx.env.step", "apx.kernel.L") in times.total


def test_entry_binds_its_signature_on_first_call(stand_in, monkeypatch):
    def bind_launch(*args):
        return 0

    lib = types.SimpleNamespace(bind_launch=bind_launch)
    monkeypatch.setattr(_launch.build, "load", lambda: lib)
    launch = stand_in(None, kernel="K2", name="bind_launch")
    launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    launch(torch.device("cpu"), 3)
    assert launch.fn is bind_launch and bind_launch.restype is ctypes.c_int
    assert bind_launch.argtypes == [ctypes.c_int, ctypes.c_void_p]


def test_clear_launches_zeroes_the_table(stand_in):
    stand_in(lambda *args: 0)(torch.device("cpu"))
    stand_in(lambda *args: 0, kernel="K1", name="other_launch")(torch.device("cpu"))
    assert _launch.launched("S") >= 1 and _launch.launched("K1") >= 1
    _launch.clear_launches()
    assert set(_launch.launches().values()) == {0}
    with pytest.raises(KeyError):
        _launch.launched("K9")
    with pytest.raises(KeyError):
        _launch.launched("S.undeclared_launch")


def test_every_kernel_id_has_a_declared_entry():
    """Every wrapper's entries name an id of ``KERNELS`` (the benchmark's
    stage split checks each kernel span's node against its symbol), and
    every id has at least one entry."""
    import apx_torch.core.numerics  # noqa: F401  (N1-N3)
    import apx_torch.ops

    for mod in pkgutil.iter_modules(apx_torch.ops.__path__):
        importlib.import_module(f"apx_torch.ops.{mod.name}")
    ids = [key.partition(".")[0] for key in _launch.launches()]
    assert set(ids) == set(_launch.KERNELS)
    with pytest.raises(ValueError, match="not one of"):
        _launch.entry("K9", "unknown_launch", [])


def test_device_counters_are_made_once_read_and_cleared(registry, monkeypatch):
    """``reset_counter`` makes R's int64 counter on a device once and hands
    back the same tensor after; ``counters`` reads it (nothing before it is
    made, summed over devices after); ``clear`` zeroes it in place; under a
    capture a counter not yet made stays unmade (None), and one made
    before is handed back."""
    monkeypatch.setattr(trace, "_RESET_COUNTS", {})
    assert trace.counters() == {}
    c = trace.reset_counter("cpu")
    assert c.dtype == torch.int64 and c.tolist() == [0, 0]
    assert trace.reset_counter(torch.device("cpu")) is c
    c += torch.tensor([16384, 163])
    assert trace.counters() == {"fused_reset": [16384, 163]}
    trace._RESET_COUNTS[torch.device("meta")] = torch.tensor([4096, 7])
    assert trace.counters() == {"fused_reset": [20480, 170]}
    del trace._RESET_COUNTS[torch.device("meta")]
    trace.clear()
    assert trace.counters() == {"fused_reset": [0, 0]}
    assert trace.reset_counter("cpu") is c
    monkeypatch.setattr(trace, "_RESET_COUNTS", {})
    monkeypatch.setattr(trace, "_OPEN", 1)
    monkeypatch.setattr(trace, "_capturing", lambda: True)
    assert trace.reset_counter("cpu") is None
    assert trace.counters() == {}
    monkeypatch.setattr(trace, "_RESET_COUNTS", {torch.device("cpu"): c})
    assert trace.reset_counter("cpu") is c


@pytest.mark.parametrize("values,share", [
    ("no counters", None), (None, None), ([0, 0], None), ([16384 * 101, 16384], 1 / 101),
    ([4096, 4096], 1.0)])
def test_reset_share_reads_the_reset_counter(values, share, monkeypatch):
    """The benchmark's ``reset_share.rollout`` is R's envs computed over
    envs asked; it reads nothing from a program without device counters,
    without R's counter, or before a masked launch."""
    reader = manifest.metric_reader("reset_share.rollout")
    if values == "no counters":
        monkeypatch.delattr(trace, "counters")
    else:
        got = {} if values is None else {"fused_reset": values}
        monkeypatch.setattr(trace, "counters", lambda: got)
    assert reader.read({}) == share


def _lidar(n=4):
    return apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")


def _act(n):
    return {"action": torch.zeros((n, 2)), "prediction": torch.zeros((n, 2))}


def test_vector_env_stages_are_spans():
    venv, p = _lidar()
    g = torch.Generator().manual_seed(0)
    with trace.timed() as times:
        _, state, _ = venv.reset(p, g)
        venv.step(state, _act(4), p, g)
    paths = set(times.total)
    assert {("apx.vector.reset", "apx.env.draw"), ("apx.vector.reset", "apx.env.reset"),
            ("apx.vector.step", "apx.env.draw"), ("apx.vector.step", "apx.env.step"),
            ("apx.vector.step", "apx.env.reset")} <= paths


def test_lockstep_and_boundary_stages_are_spans():
    venv, p = apx_torch.make_vec("CircleSquare-v0", 4, device="cpu")
    venv = vector_env(venv.env, 4, AutoResetMode.LOCKSTEP)
    g = torch.Generator().manual_seed(0)
    _, state, _ = venv.reset(p, g)
    act = {"action": torch.zeros((4, 2)), "prediction": torch.zeros((4, 2))}
    with trace.timed() as times:
        venv.step(state, act, p, g)
        venv.boundary_reset_step(state, act, p, g)
    paths = set(times.total)
    assert {("apx.vector.step", "apx.env.step"), ("apx.vector.step", "apx.env.reset"),
            ("apx.vector.boundary_reset", "apx.env.draw"),
            ("apx.vector.boundary_reset", "apx.env.reset")} <= paths


def test_loss_span_opens_at_the_op_by_op_sites():
    """``apx.vector.loss`` is open around the loss and the reward where the
    vector env computes them op by op: the LOCKSTEP step, the DISABLED step
    and the boundary step, inside their vector spans."""
    venv, p = apx_torch.make_vec("CircleSquare-v0", 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    _, state, _ = venv.reset(p, g)
    act = {"action": torch.zeros((4, 2)), "prediction": torch.zeros((4, 2))}
    for mode, entry, vector in [
            (AutoResetMode.LOCKSTEP, "step", "apx.vector.step"),
            (AutoResetMode.DISABLED, "step", "apx.vector.step"),
            (AutoResetMode.LOCKSTEP, "boundary_reset_step", "apx.vector.boundary_reset")]:
        with trace.timed() as times:
            getattr(vector_env(venv.env, 4, mode), entry)(state, act, p, g)
        loss = {path for path in times.total if "apx.vector.loss" in path}
        assert loss == {(vector, "apx.vector.loss")}, (mode, entry)


def test_sparse_and_metrics_spans_open_at_their_sites():
    """A ``-sparse`` id wrapped in its metrics: ``apx.vector.info_loss``
    opens around ``Sparsify``'s dense loss inside the vector span of each
    step (the LOCKSTEP step, the DISABLED step, the boundary step), and
    ``apx.vector.metrics`` around the wrapper's bookkeeping, outside the
    inner step, whose ``apx.env.*`` and ``apx.vector.*`` spans keep their
    paths."""
    venv, p = apx_torch.make_vec("CircleSquare-s15-sparse-v0", 4, device="cpu", metrics=True)
    g = torch.Generator().manual_seed(0)
    _, state, _ = venv.reset(p, g)
    act = {"action": torch.zeros((4, 2)), "prediction": torch.zeros((4, 2))}
    for mode, entry, vector in [
            (AutoResetMode.LOCKSTEP, "step", "apx.vector.step"),
            (AutoResetMode.DISABLED, "step", "apx.vector.step"),
            (AutoResetMode.LOCKSTEP, "boundary_reset_step", "apx.vector.boundary_reset")]:
        with trace.timed() as times:
            getattr(with_autoreset(venv, mode), entry)(state, act, p, g)
        paths = set(times.total)
        assert {path for path in paths if "apx.vector.info_loss" in path} == \
            {(vector, "apx.vector.info_loss")}, (mode, entry)
        assert {path for path in paths if "apx.vector.metrics" in path} == \
            {("apx.vector.metrics",)}, (mode, entry)
        assert (vector, "apx.vector.loss") in paths
        assert all(path[0] == vector for path in paths if "apx.env.step" in path)
        assert {stages.stage_of(path) for path in paths
                if {"apx.vector.info_loss", "apx.vector.metrics"} & set(path)} == \
            {"vector_merge"}


def test_base_ids_open_neither_new_span():
    """The base id, unwrapped, opens neither span: the four cells' layouts
    are as they were."""
    venv, p = apx_torch.make_vec("CircleSquare-s15-v0", 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    _, state, _ = venv.reset(p, g)
    with trace.timed() as times:
        venv.step(state, _act(4), p, g)
        venv.boundary_reset_step(state, _act(4), p, g)
    assert not any({"apx.vector.info_loss", "apx.vector.metrics"} & set(path)
                   for path in times.total)


def test_next_step_records_no_loss_span():
    """Under NEXT_STEP the loss is F2's (its plain form on the CPU), whose
    call is not wrapped: no ``apx.vector.loss``."""
    for env_id in ("LightDark-v0", "LIDARLocRooms-v0"):
        venv, p = apx_torch.make_vec(env_id, 4, device="cpu")
        g = torch.Generator().manual_seed(1)
        _, state, _ = venv.reset(p, g)
        with trace.timed() as times:
            venv.step(state, _act(4), p, g)
        assert ("apx.vector.step", "apx.env.step") in times.total
        assert not any("apx.vector.loss" in path for path in times.total), env_id


def test_timed_spans_do_not_change_the_step():
    venv, p = _lidar()
    outs = []
    for timing in (False, True):
        g = torch.Generator().manual_seed(3)
        _, state, _ = venv.reset(p, g)
        if timing:
            with trace.timed():
                out = venv.step(state, _act(4), p, g)
        else:
            out = venv.step(state, _act(4), p, g)
        outs.append(out)
    for a, b in zip(outs[0][0].values(), outs[1][0].values()):
        assert torch.equal(a, b)


# ---- benchmark/yardstick/stages.py on a synthetic trace ----------------------------

STEP = ("apx.vector.step",)
LAYOUT = {"capture": 1, "nodes": 5, "spans": [
    (STEP + ("apx.env.step", "apx.kernel.S"), 1, 2),
    (STEP + ("apx.env.step",), 1, 2),
    (STEP + ("apx.env.reset", "apx.kernel.R"), 2, 3),
    (STEP + ("apx.env.reset",), 2, 3),
    (STEP + ("apx.kernel.F2",), 3, 4),
    (STEP, 0, 4),
]}
# node 0: the merge's copy; 1: S; 2: R; 3: F2; 4: the harness's accumulator.
NODES = [("memcpy128", 1.0), ("apx_lidar_fused_step(...)", 40.0),
         ("void apx_lidar_fused_reset<true>(...)", 30.0), ("apx_merge_next_step(...)", 20.0),
         ("vectorized_elementwise_kernel", 2.0)]


def _trace(node_ids=True, order=None):
    events, t = [], 0.0
    for corr in (100, 200):  # two replays
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": t,
                       "dur": 3.0, "args": {"correlation": corr}})
        for k in (order or range(len(NODES))):
            name, dur = NODES[k]
            args = {"correlation": corr, **({"graph node id": 1000 + k} if node_ids else {})}
            events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t + 10 * k + 5,
                           "dur": dur, "args": args})
        t += 1000
    # The draws' copy, outside any graph launch.
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": t,
                   "dur": 2.0, "args": {"correlation": 300}})
    events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": t + 4,
                   "dur": 5.0, "args": {"correlation": 300}})
    return {"traceEvents": events}


@pytest.mark.parametrize("node_ids", [True, False])
def test_stages_split_the_device_time(node_ids):
    # Listed out of order: node ids (or start times) put them back.
    got = stages.split_us(_trace(node_ids, order=[4, 2, 0, 3, 1]), LAYOUT, trace.owners,
                          _launch.KERNELS)
    assert got == {"env_step": 80.0, "env_reset": 60.0, "vector_merge": 42.0,
                   "harness": 4.0 + 5.0}
    total = sum(float(e["dur"]) for e in _trace()["traceEvents"] if e["cat"] != "cuda_runtime")
    assert sum(got.values()) == total


def test_stages_read_nothing_where_the_layout_disagrees():
    args = (trace.owners, _launch.KERNELS)
    assert stages.split_us(_trace(), {**LAYOUT, "nodes": 6}, *args) is None  # another total
    assert stages.split_us(_trace(), {**LAYOUT, "nodes": None}, *args) is None  # not closed
    shifted = {**LAYOUT, "spans": [(p, a + 1, b + 1) for p, a, b in LAYOUT["spans"]]}
    assert stages.split_us(_trace(), shifted, *args) is None  # S's span on R's kernel
    differ = _trace()
    differ["traceEvents"][2]["name"] = "something_else"
    assert stages.split_us(differ, LAYOUT, *args) is None  # the replays differ
    assert stages.split_us({"traceEvents": []}, LAYOUT, *args) is None  # no replay


def test_stages_per_step_without_a_layout(registry):
    assert stages.per_step({"trace": _trace(), "steps": 2}, "env_step") is None


def test_stages_of_paths():
    assert stages.stage_of(None) == "harness"
    assert stages.stage_of(("apx.vector.step", "apx.env.step", "apx.kernel.S")) == "env_step"
    assert stages.stage_of(("apx.vector.boundary_reset", "apx.env.draw")) == "env_reset"
    assert stages.stage_of(("apx.vector.step", "apx.kernel.F2")) == "vector_merge"
    assert stages.stage_of(("apx.vector.step", "apx.vector.loss")) == "vector_merge"
    assert stages.stage_of(("apx.vector.boundary_reset", "apx.vector.loss",
                            "apx.kernel.N1")) == "vector_merge"
    assert stages.stage_of(("apx.gym.issue",)) == "harness"


def test_parse_trace_spans_table(tmp_path, capsys):
    events = [{"ph": "X", "cat": "user_annotation", "name": "apx.vector.step", "ts": 0,
               "dur": 50.0},
              {"ph": "X", "cat": "user_annotation", "name": "apx.kernel.S", "ts": 10,
               "dur": 8.0},
              {"ph": "X", "cat": "gpu_user_annotation", "name": "apx.vector.step", "ts": 60,
               "dur": 170.0},
              {"ph": "X", "cat": "gpu_user_annotation", "name": "apx.kernel.S", "ts": 70,
               "dur": 45.0},
              {"ph": "X", "cat": "kernel", "name": "apx_lidar_fused_step", "ts": 70, "dur": 45.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1, "dur": 2.0}]
    assert parse_trace.spans({"traceEvents": events}) == [
        ("apx.vector.step", 1, 50.0, 170.0), ("apx.kernel.S", 1, 8.0, 45.0)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    parse_trace.main([str(path), "--spans", "--steps", "2"])
    out = capsys.readouterr().out
    assert "apx.vector.step" in out and "85.00" in out and "0.50" in out


# ---- on the card -------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _capture_chunk(family, cell_name, dev, seed, bank=4096):
    """A chunk of ``cell_name``'s family captured as the benchmark captures
    it (the family's chunk, N=1024, an image family's bank cut to ``bank``,
    every draw injected, the rollout's graph): (graph, its layout, the
    chunk's draws)."""
    from benchmark.kinds import rollout

    cell = manifest.cell(manifest.load(), cell_name)
    env = family.build({**cell["config"], "bank_images": bank},
                       {**cell["traffic"], "num_envs": 1024}, 0, dev)
    g = torch.Generator(dev).manual_seed(seed)
    obs, state, _ = family.initial_reset(env, g, rollout.policy)
    draws = family.draw_pool(env, g, env.chunk)
    racc = torch.zeros(env.num_envs, device=dev)
    dacc = torch.zeros(env.num_envs, dtype=torch.int32, device=dev)
    trace.clear()
    graph = rollout._Graph(
        lambda o, s, d: family.step_chunk(env, o, s, d, racc, dacc, rollout.policy),
        obs, state, draws)
    (layout,) = trace.layouts()
    return graph, layout, draws


@pytest.mark.cuda
def test_captured_lidar_chunk_layout_matches_its_graph(dev, registry, tmp_path):
    """A 16-step LIDARLocRooms-v0 chunk captured as the benchmark captures
    it: the layout's total is the graph's device nodes (counted on the
    kept graph) and the events of a traced replay, and every kernel span
    holds exactly one node, which carries the kernel's symbol."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile

    from apx_torch.ops import build

    n, steps = 1024, 16
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device=dev)
    g = torch.Generator(dev).manual_seed(5)
    obs, state, _ = venv.reset(p, g)
    draws = [venv.env.draw_reset(n, p, g) for _ in range(steps)]
    act = [{"action": torch.rand((n, 2), generator=g, device=dev) * 2 - 1,
            "prediction": torch.randn((n, 2), generator=g, device=dev)} for _ in range(steps)]

    def chunk(state):
        for j in range(steps):
            obs, state, *_ = venv.step(state, act[j], p, reset_draws=draws[j], step_draws={})
        return obs, state

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chunk(state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = chunk(state)
    (layout,) = trace.layouts()
    nodes = ctypes.c_longlong()
    assert build.load().apx_graph_device_nodes(graph.raw_cuda_graph(),
                                               ctypes.byref(nodes)) == 0
    assert layout["nodes"] == nodes.value > 0
    kernel_spans = [(path, a, b) for path, a, b in layout["spans"]
                    if path[-1].startswith("apx.kernel.")]
    assert {path[-1] for path, _, _ in kernel_spans} == {
        "apx.kernel.S", "apx.kernel.R", "apx.kernel.F2"}
    assert len(kernel_spans) == 3 * steps and all(b - a == 1 for _, a, b in kernel_spans)
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
    path = tmp_path / "replays.json"
    prof.export_chrome_trace(str(path))
    got = stages.split_us(json.loads(path.read_text()), layout, trace.owners, _launch.KERNELS)
    assert got is not None and got["env_step"] > 0 and got["env_reset"] > 0
    assert got["vector_merge"] > 0
    assert np.isfinite(out[0]["lidar"].cpu().numpy()).all()


@pytest.mark.cuda
def test_captured_light_dark_chunk_lies_in_the_stages(dev, registry, tmp_path):
    """A 16-step LightDark-v0 chunk captured as the benchmark's
    ``light_dark.rollout`` captures it (the family's chunk, every draw
    injected, the rollout's graph): the spans around each graph node are
    nested, so each node lies in exactly one stage, and every stage has
    nodes; F2 lies under ``apx.vector.step`` once a step; L lies under
    ``apx.env.step`` (the whole step) and ``apx.env.reset`` (the reset's
    noisy observation) once a step each, and no N1-N3 is launched; a trace
    of replays splits by the layout."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from benchmark.families import light_dark as family

    graph, layout, draws = _capture_chunk(family, "light_dark.rollout", dev, 6)
    steps = draws["action"].shape[0]
    total = layout["nodes"]
    own = trace.owners(layout)
    assert total > 0 and len(own) == total
    for k in range(total):
        holding = [path for path, a, b in layout["spans"] if a <= k < b]
        inner = max(holding, key=len, default=())
        assert all(inner[:len(path)] == path for path in holding), holding
    by_stage = collections.Counter(stages.stage_of(path) for path in own)
    assert set(by_stage) == set(stages.STAGES) and all(by_stage.values())
    kernels = collections.Counter()
    for path, a, b in layout["spans"]:
        if path[-1].startswith("apx.kernel."):
            assert b - a == 1, path
            kernels[(path[-1][len("apx.kernel."):], stages.stage_of(path))] += 1
            if path[-1] == "apx.kernel.F2":
                assert path == ("apx.vector.step", "apx.kernel.F2")
    assert dict(kernels) == {
        ("F2", "vector_merge"): steps, ("L", "env_step"): steps, ("L", "env_reset"): steps}
    graph.replay(draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay(draws)
        graph.replay(draws)
        torch.cuda.synchronize()
    path = tmp_path / "replays.json"
    prof.export_chrome_trace(str(path))
    got = stages.split_us(json.loads(path.read_text()), layout, trace.owners, _launch.KERNELS)
    assert got is not None and all(got[s] > 0 for s in stages.STAGES)


@pytest.mark.cuda
def test_captured_tin_loc_chunk_lies_in_the_stages(dev, registry, tmp_path):
    """A 17-step TinyImageNetLoc-v0 chunk captured as the benchmark's
    ``tin_loc.rollout`` captures it (the family's chunk: the boundary reset,
    then 16 steps; every draw injected; a smaller bank): each node lies in
    exactly one stage, and every stage has nodes; each of the 16 steps
    launches M and K3 once under ``apx.env.step`` and nothing else there,
    no N1-N3 in ``env_step``; the boundary's reset takes its two glimpses
    (obs and target) under ``apx.env.reset``; a trace of replays splits by
    the layout."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from benchmark.families import image_loc as family

    graph, layout, draws = _capture_chunk(family, "tin_loc.rollout", dev, 7)
    steps = draws["action"].shape[0]
    total = layout["nodes"]
    own = trace.owners(layout)
    assert total > 0 and len(own) == total
    for k in range(total):
        holding = [path for path, a, b in layout["spans"] if a <= k < b]
        inner = max(holding, key=len, default=())
        assert all(inner[:len(path)] == path for path in holding), holding
    by_stage = collections.Counter(stages.stage_of(path) for path in own)
    assert set(by_stage) == set(stages.STAGES) and all(by_stage.values())
    kernels = collections.Counter()
    for path, a, b in layout["spans"]:
        if path[-1].startswith("apx.kernel."):
            assert b - a == 1, path
            kernels[(path[-1][len("apx.kernel."):], stages.stage_of(path))] += 1
    in_step = {k: v for (k, stage), v in kernels.items() if stage == "env_step"}
    assert in_step == {"M": steps - 1, "K3": steps - 1}
    assert by_stage["env_step"] == 2 * (steps - 1)  # M and K3 are the step's only nodes
    assert kernels[("K3", "env_reset")] == 2
    assert not any(k in ("N2", "N3") for k, _ in kernels)
    graph.replay(draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay(draws)
        graph.replay(draws)
        torch.cuda.synchronize()
    path = tmp_path / "replays.json"
    prof.export_chrome_trace(str(path))
    got = stages.split_us(json.loads(path.read_text()), layout, trace.owners, _launch.KERNELS)
    assert got is not None and all(got[s] > 0 for s in stages.STAGES)


def _loss_spans_hold_one_p_node(layout: dict) -> list[tuple]:
    """The layout's ``apx.vector.loss`` ranges, after checking that each
    holds exactly one node, P's launch (an ``apx.kernel.P`` span over the
    same node)."""
    spans = [(path, a, b) for path, a, b in layout["spans"] if path[-1] == "apx.vector.loss"]
    p_nodes = {(a, b): path for path, a, b in layout["spans"] if path[-1] == "apx.kernel.P"}
    for path, a, b in spans:
        assert b - a == 1 and p_nodes.get((a, b)) == path + ("apx.kernel.P",), (path, a, b)
    assert len(p_nodes) == len(spans)
    return spans


def _covers_every_node(replays: dict, split: dict | None) -> bool:
    """The four stages add up to every device event of the trace: each node
    of each replay and each copy outside them lies in one stage."""
    from benchmark.yardstick import trace as tr

    total = sum(float(e.get("dur", 0)) for e in tr.device_events(replays))
    return split is not None and sum(split.values()) == pytest.approx(total, rel=1e-9)


@pytest.mark.cuda
def test_captured_classification_chunk_has_a_loss_span_a_step(dev, registry, tmp_path):
    """A 17-step TinyImageNet-v0 chunk captured as ``tin_cls.rollout``
    captures it: an ``apx.vector.loss`` range of nodes at each of the 17
    steps, inside the boundary's or the step's vector span, its nodes in
    the ``vector_merge`` stage; each range holds one node, P's launch,
    whose traced kernel carries ``apx_loss_``; a trace of replays gives the
    span a time, and the four stages cover every node."""
    from benchmark.families import image_cls as family
    from benchmark.yardstick import loss

    graph, layout, draws = _capture_chunk(family, "tin_cls.rollout", dev, 8)
    spans = _loss_spans_hold_one_p_node(layout)
    assert [path for path, _, _ in spans] == \
        [("apx.vector.boundary_reset", "apx.vector.loss")] + \
        [("apx.vector.step", "apx.vector.loss")] * 16
    own = trace.owners(layout)
    assert {stages.stage_of(path) for path in own if path and "apx.vector.loss" in path} == \
        {"vector_merge"}
    graph.replay(draws)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay(draws)
        graph.replay(draws)
        torch.cuda.synchronize()
    path = tmp_path / "replays.json"
    prof.export_chrome_trace(str(path))
    replays = json.loads(path.read_text())
    split = stages.split_us(replays, layout, trace.owners, _launch.KERNELS)
    got = loss.span_us(replays, layout, trace.owners, _launch.KERNELS)
    assert split is not None and got is not None and 0 < got < split["vector_merge"]
    assert _covers_every_node(replays, split)
    runs, _ = stages.replays(replays)
    assert all(_launch.KERNELS["P"] in str(run[a]["name"]) for run in runs for _, a, _ in spans)


@pytest.mark.cuda
def test_loss_span_adds_no_node_and_keeps_the_stages(dev, registry, monkeypatch, tmp_path):
    """A ``tin_loc``-shaped chunk captured with the loss span and with it
    made inert: the same device nodes, each in the same stage; the span's
    nodes are ``vector_merge``'s, one in each of the 17 ranges: P's launch
    (the MSE and its reward), whose traced kernel carries ``apx_loss_``;
    the four stages cover every node of a trace of replays."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from apx_torch.core import env as core_env
    from benchmark.families import image_loc as family

    graph, with_span, draws = _capture_chunk(family, "tin_loc.rollout", dev, 9)
    spans = _loss_spans_hold_one_p_node(with_span)
    assert len(spans) == 17
    graph.replay(draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay(draws)
        graph.replay(draws)
        torch.cuda.synchronize()
    path = tmp_path / "replays.json"
    prof.export_chrome_trace(str(path))
    replays = json.loads(path.read_text())
    assert _covers_every_node(replays, stages.split_us(replays, with_span, trace.owners,
                                                       _launch.KERNELS))
    runs, _ = stages.replays(replays)
    assert all(_launch.KERNELS["P"] in str(run[a]["name"]) for run in runs for _, a, _ in spans)
    real = core_env.span
    monkeypatch.setattr(core_env, "span", lambda name: contextlib.nullcontext()
                        if name == "vector.loss" else real(name))
    _, without, _ = _capture_chunk(family, "tin_loc.rollout", dev, 9)
    assert not any("apx.vector.loss" in path for path, _, _ in without["spans"])
    assert with_span["nodes"] == without["nodes"] > 0
    own, plain = trace.owners(with_span), trace.owners(without)
    assert [stages.stage_of(p) for p in own] == [stages.stage_of(p) for p in plain]
    in_loss = [p for p in own if p and "apx.vector.loss" in p]
    assert in_loss and {stages.stage_of(p) for p in in_loss} == {"vector_merge"}


def _inert_new_spans(monkeypatch):
    """Make ``apx.vector.info_loss`` and ``apx.vector.metrics`` inert, as in
    a program without them."""
    import contextlib

    from apx_torch.wrappers import sparsify

    real_span, real_call = sparsify.span, trace.call
    monkeypatch.setattr(sparsify, "span", lambda name: contextlib.nullcontext()
                        if name == "vector.info_loss" else real_span(name))
    monkeypatch.setattr(trace, "call", lambda name, fn, *a, **kw: fn(*a, **kw)
                        if name == "vector.metrics" else real_call(name, fn, *a, **kw))


def _replays(graph, draws, tmp_path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    graph.replay(draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay(draws)
        graph.replay(draws)
        torch.cuda.synchronize()
    path = tmp_path / "replays.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


@pytest.mark.cuda
def test_captured_sparse_metrics_chunk_has_both_spans_a_step(dev, registry, monkeypatch,
                                                             tmp_path):
    """A 17-step TinyImageNet-sparse-v0 chunk with its metrics wrapper,
    captured as ``tin_cls_sparse.rollout`` captures it: an
    ``apx.vector.info_loss`` range inside the boundary's or the step's
    vector span, and an ``apx.vector.metrics`` range outside it, at each of
    the 17 steps; the spans around each node are nested, so each node lies
    in one stage, and every stage has nodes; a trace of replays gives both
    losses and the metrics a time inside ``vector_merge``, and the four
    stages cover every node. Captured again with the two spans inert: the
    same nodes, each in the same stage but the metrics' (the harness's
    without their span)."""
    from benchmark.families import image_cls_sparse as family
    from benchmark.yardstick import loss, sparse

    graph, layout, draws = _capture_chunk(family, "tin_cls_sparse.rollout", dev, 10)
    steps = draws["action"].shape[0]
    named = [path for path, _, _ in layout["spans"]
             if path[-1] in ("apx.vector.info_loss", "apx.vector.metrics")]
    assert [p for p in named if p[-1] == "apx.vector.info_loss"] == \
        [("apx.vector.boundary_reset", "apx.vector.info_loss")] + \
        [("apx.vector.step", "apx.vector.info_loss")] * (steps - 1)
    assert [p for p in named if p[-1] == "apx.vector.metrics"] == \
        [("apx.vector.metrics",)] * steps
    total = layout["nodes"]
    own = trace.owners(layout)
    assert total > 0 and len(own) == total
    for k in range(total):
        holding = [path for path, a, b in layout["spans"] if a <= k < b]
        inner = max(holding, key=len, default=())
        assert all(inner[:len(path)] == path for path in holding), holding
    assert {stages.stage_of(path) for path in own} == set(stages.STAGES)
    new = [path for path in own if path and
           {"apx.vector.info_loss", "apx.vector.metrics"} & set(path)]
    assert new and {stages.stage_of(path) for path in new} == {"vector_merge"}
    replays = _replays(graph, draws, tmp_path)
    split = stages.split_us(replays, layout, trace.owners, _launch.KERNELS)
    both = sparse.union_us(replays, layout, trace.owners, _launch.KERNELS)
    weighted = loss.span_us(replays, layout, trace.owners, _launch.KERNELS)
    metrics = loss.span_us(replays, layout, trace.owners, _launch.KERNELS,
                           sparse.METRICS_SPAN)
    assert split is not None and 0 < weighted < both
    assert 0 < metrics and both + metrics < split["vector_merge"]
    assert _covers_every_node(replays, split)
    _inert_new_spans(monkeypatch)
    _, without, _ = _capture_chunk(family, "tin_cls_sparse.rollout", dev, 10)
    assert not any({"apx.vector.info_loss", "apx.vector.metrics"} & set(path)
                   for path, _, _ in without["spans"])
    assert without["nodes"] == total
    plain = trace.owners(without)
    assert [("harness" if p and "apx.vector.metrics" in p else stages.stage_of(p))
            for p in own] == [stages.stage_of(p) for p in plain]


@pytest.mark.cuda
def test_tin_cls_capture_is_unchanged_by_the_new_spans(dev, registry, monkeypatch):
    """A ``tin_cls``-shaped chunk opens neither new span, and has the same
    device nodes, each in the same stage, with the two spans live and made
    inert."""
    from benchmark.families import image_cls as family

    _, live, _ = _capture_chunk(family, "tin_cls.rollout", dev, 11)
    assert not any({"apx.vector.info_loss", "apx.vector.metrics"} & set(path)
                   for path, _, _ in live["spans"])
    _inert_new_spans(monkeypatch)
    _, inert, _ = _capture_chunk(family, "tin_cls.rollout", dev, 11)
    assert live["nodes"] == inert["nodes"] > 0
    assert [stages.stage_of(p) for p in trace.owners(live)] == \
        [stages.stage_of(p) for p in trace.owners(inert)]
