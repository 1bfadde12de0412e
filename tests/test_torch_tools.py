"""The port's tools against apx's on the CPU: ``mk_env_doc`` pages byte
for byte but for the lines that name the package, ``create_env_vid``
frames bitwise (``create_gifs`` driving it over the same id list), and
``parse_trace`` on torch.profiler chrome traces: a hand-written one with
two overlapping streams (the busy time a union) and a real CPU trace (host
rows only; ``device_busy_us`` raises, as apx's does)."""

import gzip
import json
import os

import jax  # noqa: F401  (conftest pins the cpu backend)
import numpy as np
import pytest
import torch

from apx.tools import create_env_vid as apx_vid, create_gifs as apx_gifs
from apx.tools import mk_env_doc as apx_doc, parse_trace as apx_trace
from apx_torch.tools import create_env_vid as port_vid, create_gifs as port_gifs
from apx_torch.tools import mk_env_doc as port_doc, parse_trace as pt

torch.set_num_threads(1)


def test_mk_env_doc_pages_match_apx(tmp_path):
    """Every page of apx's set, each line equal to apx's once the package
    name is the port's, and only the banner, the usage line and the four
    module paths differ."""
    apx_pages = apx_doc.generate(str(tmp_path / "apx"))
    port_pages = port_doc.generate(str(tmp_path / "port"), device="cpu")
    assert port_pages == apx_pages and len(apx_pages) == 17
    differing = set()
    for page in apx_pages:
        a = (tmp_path / "apx" / page).read_text().splitlines()
        b = (tmp_path / "port" / page).read_text().splitlines()
        assert len(a) == len(b), page
        for x, y in zip(a, b):
            if x != y:
                assert y == x.replace("apx.", "apx_torch."), (page, x, y)
                differing.add(x.split()[0] if x.startswith("<!--") else x.split(" (")[0])
    assert differing == {
        "<!--",
        "import apx.compat.ap_gym_alias  # or: import ap_gym",
        "`apx.envs.image_classification.ImageClassificationEnv`",
        "`apx.envs.image_localization.ImageLocalizationEnv`",
        "`apx.envs.lidar_localization.LIDARLocalizationEnv`",
        "(`apx.envs.image_perception.ImagePerceptionParams`, mirror of the",
    }, differing


@pytest.fixture()
def captured(monkeypatch):
    """imageio.mimsave replaced by a recorder of (path, frames, kwargs)."""
    import imageio

    calls = []
    monkeypatch.setattr(imageio, "mimsave",
                        lambda path, frames, **kw: calls.append((path, list(frames), kw)))
    return calls


@pytest.mark.parametrize("env_id,steps", [("LightDark-v0", 60), ("LIDARLocRooms-v0", 104)])
def test_create_env_vid_frames_match_apx(env_id, steps, captured):
    """Seed 0 rollouts across an episode end (LightDark's 50-step limit,
    LIDAR's 100): every frame bitwise apx's, at the same fps."""
    n_apx = apx_vid.create_env_vid(env_id, "apx.gif", steps=steps, seed=0)
    n_port = port_vid.create_env_vid(env_id, "port.gif", steps=steps, seed=0, device="cpu")
    assert n_apx == n_port == steps + 1
    (_, a, kw_a), (_, b, kw_b) = captured
    assert kw_a == kw_b
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype == np.uint8
        np.testing.assert_array_equal(x, y, err_msg=f"frame {i}")


def test_create_gifs_drives_the_same_ids(captured, monkeypatch, tmp_path):
    assert port_gifs.VISUAL_ENVS == apx_gifs.VISUAL_ENVS
    monkeypatch.setattr("sys.argv", ["create_gifs", "--out", str(tmp_path), "--steps", "3",
                                     "--ids", "CircleSquare-v0", "--device", "cpu"])
    port_gifs.main()
    assert [c[0] for c in captured] == [os.path.join(str(tmp_path), "CircleSquare-v0.gif")]
    assert len(captured[0][1]) == 4


def _x(name, ts, dur, pid, tid, cat):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}


def _torch_format_trace():
    """A trace in torch.profiler's chrome format: a host process, a device
    process (labelled "GPU 0") with two streams whose kernels overlap, a
    memcpy and a memset, flow events, the profiler's overhead and its
    whole-window "Trace" span."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": 77, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 77, "tid": 0, "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7 "}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 9, "args": {"name": "stream 9 "}},
    ]
    events = [
        _x("PyTorch Profiler (0)", 0.0, 1000.0, "Spans", "PyTorch Profiler", "Trace"),
        _x("aten::add", 5.0, 20.0, 77, 77, "cpu_op"),
        _x("cudaLaunchKernel", 10.0, 5.0, 77, 77, "cuda_runtime"),
        _x("step", 90.0, 200.0, 77, 77, "user_annotation"),
        _x("aten::mul", 120.0, 150.0, 77, 77, "cpu_op"),
        _x("Activity Buffer Request", 400.0, 50.0, -1, 0, "overhead"),
        _x("add_kernel", 100.0, 10.0, 0, 7, "kernel"),  # [100, 110)
        _x("mul_kernel", 105.0, 10.0, 0, 9, "kernel"),  # overlaps: union [100, 115)
        _x("add_kernel", 300.0, 5.0, 0, 7, "kernel"),  # [300, 305)
        _x("Memcpy HtoD (Pageable -> Device)", 305.0, 3.0, 0, 7, "gpu_memcpy"),  # touches
        _x("Memset (Device)", 500.0, 2.0, 0, 9, "gpu_memset"),  # [500, 502)
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 77, "tid": 77, "ts": 10.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0, "tid": 7, "ts": 100.0,
         "bp": "e"},
        {"ph": "i", "name": "Iteration Start: PyTorch Profiler", "pid": "Traces", "tid": "x",
         "ts": 0.0, "s": "g"},
    ]
    return {"schemaVersion": 1, "traceEvents": meta + events}


def test_parse_trace_union_counts_overlap_once(tmp_path, capsys):
    trace = _torch_format_trace()
    assert len(pt.device_events(trace)) == 5
    # Union: [100, 115) + [300, 308) + [500, 502) = 15 + 8 + 2; the sum
    # counts the 5 us overlap of the two streams twice.
    assert pt.device_busy_us(trace) == 25.0
    assert pt.device_summed_us(trace) == 30.0
    rows = pt.summarize(trace)
    assert rows[0] == ("GPU 0", "add_kernel", 15.0, 2)
    assert {r[1] for r in rows} == {"add_kernel", "mul_kernel", "Memcpy HtoD (Pageable -> Device)",
                                    "Memset (Device)"}
    assert {r[0] for r in pt.summarize(trace, device_only=False)} == {"GPU 0", "CPU", "Spans", "-1"}
    gaps = pt.idle_gaps(trace, top=5)
    # [115, 300): the shortest host event covering it is "step" [90, 290)?
    # No: it ends at 290, so none covers; the largest overlap is "step".
    # [308, 500): the overhead event overlaps it most (50 us).
    assert [(g["start_us"], g["us"], g["host"], g["host_cat"]) for g in gaps] == [
        (308.0, 192.0, "Activity Buffer Request", "overhead"),
        (115.0, 185.0, "step", "user_annotation"),
    ]
    # Covered gaps name the innermost covering host event.
    trace["traceEvents"].append(_x("inner", 110.0, 195.0, 77, 77, "cpu_op"))
    assert pt.idle_gaps(trace, top=2)[1]["host"] == "inner"
    # .json, .json.gz and a directory (its newest trace) load alike.
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_torch_format_trace()))
    with gzip.open(tmp_path / "t.json.gz", "wt") as f:
        json.dump(_torch_format_trace(), f)
    os.utime(tmp_path / "t.json.gz", (1e9, 2e9))
    for p in (path, tmp_path / "t.json.gz", tmp_path):
        assert pt.device_busy_us(pt.load_trace(str(p))) == 25.0
    pt.main([str(path), "--steps", "5"])
    out = capsys.readouterr().out
    assert "device busy (union): 0.0050 ms per step of 5" in out
    assert "idle gap 192.0 us" in out


def test_parse_trace_on_a_cpu_profiler_trace(tmp_path, capsys):
    """A real torch.profiler trace of CPU work: only host rows; the device
    table is empty and device_busy_us raises ValueError, as apx's does on
    the same file."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            (x @ x).sum()
    path = str(tmp_path / "cpu.json")
    prof.export_chrome_trace(path)
    trace = pt.load_trace(path)
    assert pt.device_events(trace) == [] and pt.summarize(trace) == []
    host = pt.summarize(trace, device_only=False)
    names = {r[1] for r in host}
    assert "aten::mm" in names or "aten::matmul" in names
    assert {r[1]: r[3] for r in host}["aten::matmul"] == 3
    with pytest.raises(ValueError):
        pt.device_busy_us(trace)
    with pytest.raises(ValueError):
        pt.idle_gaps(trace)
    with pytest.raises(ValueError):
        apx_trace.device_busy_us(apx_trace.load_trace(path))
    pt.main([path])
    assert "no device rows in this trace" in capsys.readouterr().out
