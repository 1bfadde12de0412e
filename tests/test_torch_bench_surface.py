"""The port's bench (``apx_torch.bench``) against apx's ``bench.py``, on
the CPU, with no card: the workloads and their env configs, trajectories
of the three workloads apx benches that the port's bench lacked until
now, the obs bytes behind the roofline stats, the ``--deep`` plan, the
``--emit`` documents and the command line's refusals. apx's ``main`` runs
with its measurements replaced by recorders, so its plan and documents
are read from apx itself.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench

from apx_torch import bench
from apx_torch.bench import BANKED, COMPAT_IDS, WORKLOADS

torch.set_num_threads(1)
CPU = torch.device("cpu")
NEW = ("lidar_maze", "lidar_rooms_static", "cifar10")


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


def test_workloads_cover_apx_benches():
    assert set(jbench.BENCHES) <= set(WORKLOADS)
    assert set(WORKLOADS) - set(jbench.BENCHES) == {"lidar_rooms_window"}
    assert BANKED == jbench.BANKED
    assert set(bench.LOCKSTEP_WORKLOADS) == {
        name for name in jbench.BENCHES
        if jbench._make(name, 4, 16 if name in BANKED else None)[0].autoreset.name == "LOCKSTEP"}


@pytest.mark.parametrize("name", ["lidar_maze", "lidar_rooms_static"])
def test_lidar_builders_give_apx_config(name):
    jvenv, jp, _ = jbench._make(name, 8, None)
    venv, p = WORKLOADS[name][1](8, CPU)
    assert venv.autoreset.name == jvenv.autoreset.name == "NEXT_STEP"
    assert (venv.env.max_episode_steps, venv.env.issue_termination) == \
        (jvenv.env.max_episode_steps, jvenv.env.issue_termination) == (100, True)
    assert (p.static_map, p.static_map_pos) == (jp.static_map, jp.static_map_pos)
    ours, ref = p.map_bank, jp.map_bank
    np.testing.assert_array_equal(ours.maps.numpy(), np.asarray(ref.maps))
    np.testing.assert_array_equal(ours.indices.numpy(), np.asarray(ref.indices).astype(np.int64))
    np.testing.assert_array_equal(ours.free_cells.numpy(), np.asarray(ref.free_cells))
    assert ours.kind == ref.kind
    shape = {"lidar_maze": (256, 21, 21), "lidar_rooms_static": (1, 32, 32)}[name]
    assert tuple(ours.maps.shape) == shape


@pytest.mark.parametrize("bank_points", [None, 96])
def test_cifar10_builder_gives_apx_config(bank_points):
    jvenv, jp, _ = jbench._make("cifar10", 8, bank_points)
    venv, p = WORKLOADS["cifar10"][1](8, CPU, bank_points=bank_points)
    assert venv.autoreset.name == jvenv.autoreset.name == "LOCKSTEP"
    assert (p.step_limit, tuple(p.sensor_size)) == (jp.step_limit, tuple(jp.sensor_size))
    ref = np.asarray(jp.dataset.images_unpacked)
    assert p.dataset.length == ref.shape[0] == (bank_points or 8192)
    assert tuple(p.dataset.images.shape) == ref.shape == (ref.shape[0], 32, 32, 3)
    np.testing.assert_array_equal(p.dataset.images.numpy(), ref)
    np.testing.assert_array_equal(p.dataset.labels.numpy(),
                                  np.asarray(jp.dataset.labels).astype(np.int64))


def test_real_banks_use_the_split_sizes():
    """``--real-banks``: each banked workload's bank at its split's size
    (only cifar10's is built here)."""
    for name in BANKED:
        assert bench._bank_points(name, None, True) == jbench.BANKED[name]
        assert bench._bank_points(name, 100, False) == 100
    assert bench._bank_points("lidar_rooms", 100, True) is None
    venv, p = WORKLOADS["cifar10"][1](4, CPU, bank_points=bench._bank_points("cifar10", None, True))
    assert tuple(p.dataset.images.shape) == (50000, 32, 32, 3)


def test_tin_loc_takes_the_streamed_sampler_above_8192():
    assert WORKLOADS["tin_loc"][1](8192, CPU)[1].unique_sampling_backend == "auto"
    assert WORKLOADS["tin_loc"][1](8200, CPU)[1].unique_sampling_backend == "streamed"
    assert jbench.make_tin_loc(8200)[1].unique_sampling_backend == "streamed"


def _lidar_draws(params):
    bank = params.map_bank

    def one(key):
        k_map, k_cell = jax.random.split(key)
        if params.static_map:
            pos = jnp.full((), params.static_map_pos, dtype=jnp.int32)
        else:
            pos = jax.random.randint(k_map, (), 0, bank.num_maps, dtype=jnp.int32)
        return pos, jax.random.randint(k_cell, (), 0, jnp.take(bank.free_counts, pos),
                                       dtype=jnp.int32)

    batched = jax.jit(jax.vmap(one))

    def draws(keys):
        pos, k = batched(keys)
        return {"bank_pos": torch.from_numpy(np.asarray(pos).astype(np.int64)),
                "k": torch.from_numpy(np.asarray(k).astype(np.int64))}

    return draws


def _image_draws(params):
    def one(key):
        k_idx, k_inv, k_pos = jax.random.split(key, 3)
        idx = jax.random.randint(k_idx, (), 0, params.dataset.length, dtype=jnp.int32)
        inv = (jax.random.randint(k_inv, (), 0, 2) == 1) if params.randomly_invert_labels \
            else jnp.zeros((), dtype=jnp.bool_)
        return idx, inv, jax.random.uniform(k_pos, (2,), minval=-1.0, maxval=1.0)

    batched = jax.jit(jax.vmap(one))

    def draws(keys):
        idx, inv, pos = batched(keys)
        return {"index": torch.from_numpy(np.array(idx, dtype=np.int64)),
                "inverted": torch.from_numpy(np.array(inv)),
                "pos": torch.from_numpy(np.array(pos))}

    return draws


@pytest.mark.parametrize("name", NEW)
def test_new_workloads_trajectory_equals_apx(name):
    """20 steps of apx's builder (jitted) and of the port's workload from
    the same actions, predictions and reset draws: the LIDAR pair bitwise
    (obs, states, rewards, dones), cifar10 with its states, dones and
    non-glimpse obs bitwise, glimpses and rewards within 1e-6."""
    n = 16
    jvenv, jp, _ = jbench._make(name, n, None)
    venv, p = WORKLOADS[name][1](n, CPU)
    lidar = name != "cifar10"
    draws = (_lidar_draws if lidar else _image_draws)(jp)
    key = jax.random.PRNGKey(7)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    obs, s, _ = venv.reset(p, draws=draws(jax.random.split(key, n)))
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(3)
    pred_shape = venv.env.prediction_space(p).shape
    for t in range(20):
        what = f"{name} step {t}"
        for k in jobs:
            if k == "glimpse":
                assert np.abs(np.asarray(jobs[k]) - obs[k].numpy()).max() <= 1e-6, what
            else:
                _eq(jobs[k], obs[k], f"{what} obs {k}")
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        pred = rng.standard_normal((n, *pred_shape)).astype(np.float32)
        jobs, js, jr, jte, jtr, _ = step(
            kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(pred)}, jp)
        _, reset_key = jax.random.split(kt)  # apx's VectorAPEnv.step split
        obs, s, r, te, tr, _ = venv.step(
            s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(pred)}, p,
            reset_draws=draws(jax.random.split(reset_key, n)))
        _eq(jte, te, f"{what} terminated")
        _eq(jtr, tr, f"{what} truncated")
        if lidar:
            _eq(jr, r, f"{what} reward")
            ji, ti = js.inner.inner, s.inner.inner
            _eq(ji.pos, ti.pos, f"{what} pos")
            _eq(np.asarray(ji.map_idx).astype(np.int64), ti.map_idx, f"{what} map_idx")
        else:
            assert np.abs(np.asarray(jr, dtype=np.float64) - r.numpy()).max() <= 1e-6, what
            _eq(js.inner.pos, s.inner.pos, f"{what} pos")
            _eq(np.asarray(js.inner.data_index).astype(np.int64), s.inner.data_index,
                f"{what} data_index")


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_obs_bytes_per_step_equal_apx(name):
    """``obs_bytes_per_step`` (the leaves' bytes of one vector step's obs)
    equals apx's integer at N = 64; the window backend's equals the dense
    env's."""
    jvenv, jp, _ = jbench._make("lidar_rooms" if name == "lidar_rooms_window" else name, 64,
                                None)
    jobs, _, _ = jax.jit(jvenv.reset)(jax.random.key(0), jp)
    want = int(sum(leaf.size * leaf.dtype.itemsize for leaf in jax.tree_util.tree_leaves(jobs)))
    lp = bench._loop(name, 64, CPU)
    obs, _, _ = lp.venv.reset(lp.params, torch.Generator().manual_seed(0))
    assert bench.obs_bytes(obs) == want


def test_probe_forms():
    """``step`` folds one element of every leaf in apx's tree order,
    ``leaf1`` of the first (sorted) leaf only."""
    obs = {"b": torch.tensor([[2.0, 5.0]]), "a": torch.tensor([[3.0]]),
           "c": torch.tensor([7], dtype=torch.int32)}
    assert float(bench._probe(obs)) == 12.0
    assert float(bench._probe(obs, "leaf1")) == 3.0


def test_draws_hoisted_under_apx_budget():
    """Each leaf of the whole run's draws is hoisted up to apx's 256 MB;
    mnist's (N, 10) predictions at N = 16384 and 1024 steps are not."""
    assert bench.HOIST_BUDGET_BYTES == jbench.HOIST_BUDGET_BYTES
    lp = bench._loop("lidar_rooms", 64, CPU)
    assert bench.largest_draw_leaf_bytes(lp, 1024) == 1024 * 64 * 8
    for name, hoisted in (("lidar_rooms", True), ("tin_loc", True), ("mnist", False)):
        lp = bench._loop(name, bench.SCALING_N, CPU)
        got = bench.largest_draw_leaf_bytes(lp, 1024) <= bench.HOIST_BUDGET_BYTES
        assert got == hoisted, name


def test_spans_cover_the_steps():
    lp = bench._loop("lidar_rooms", 4, CPU)
    assert bench._spans(lp, 200) == [(16 * i, 16) for i in range(12)] + [(192, 8)]
    assert bench._spans(lp, 32) == [(0, 16), (16, 16)]
    lp = bench._loop("circle_square", 4, CPU)
    assert bench._spans(lp, 34) == [(0, 17), (17, 17)]
    with pytest.raises(ValueError):
        bench._spans(lp, 40)


def _run_apx_main(monkeypatch, tmp_path, argv):
    """apx's ``bench.main`` with its measurements replaced by recorders:
    returns the device rows (name, N, steps, key impl), the compat rows
    (id, N, steps) and the document ``--emit`` wrote."""
    rows, compat = [], []

    class Venv:
        def __init__(self, name, n):
            self.name, self.num_envs = name, n

    def make(name, num_envs, bank_points):
        return Venv(name, num_envs), None, 1.0

    def bench_env(venv, params, steps, key, stats=None, obs_probe="step"):
        rows.append((venv.name, venv.num_envs, steps, str(jax.random.key_impl(key))))
        return 1.0

    def bench_compat(env_id, n, steps):
        compat.append((env_id, n, steps))
        return 1.0

    monkeypatch.setattr(jbench, "_make", make)
    monkeypatch.setattr(jbench, "bench_env", bench_env)
    monkeypatch.setattr(jbench, "bench_compat", bench_compat)
    monkeypatch.setattr(jbench, "calibration_number", lambda: 1.0)
    out = tmp_path / "apx.json"
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv, "--emit", str(out)])
    jbench.main()
    return rows, compat, json.loads(out.read_text())


def test_deep_plan_equals_apx_less_prng_ab(monkeypatch, tmp_path):
    rows, compat, _ = _run_apx_main(monkeypatch, tmp_path,
                                    ["--deep", "--num-envs", "4096", "--steps", "1024"])
    want = [r[:3] for r in rows if "rbg" not in r[3]]
    assert len(want) == len(rows) - 3  # prng_ab's three rows
    plan = bench.deep_plan(4096, 1024)
    got = [(r["name"], r["num_envs"], r["steps"]) for r in plan
           if r["segment"] != "compat" and r["name"] != "lidar_rooms_window"]
    assert got == want
    assert [(COMPAT_IDS[r["name"]], r["num_envs"], r["steps"]) for r in plan
            if r["segment"] == "compat"] == compat
    assert {r["name"] for r in plan if r["segment"] == "sweep"} == set(WORKLOADS)
    assert set(bench.DEEP_OMITTED) == {"prng_ab"}
    for name, env_id in COMPAT_IDS.items():
        assert jbench.COMPAT_IDS[name] == env_id
    # hide_and_seek's vector wrapper needs make_vec's gymnasium shell
    assert set(jbench.COMPAT_IDS) - set(COMPAT_IDS) == {"hide_and_seek"}


@pytest.mark.parametrize("argv,mode", [
    ([], {"real_banks": False}), (["--real-banks"], {"real_banks": True}),
    (["--deep"], {"deep": True}), (["--ab-banks"], {"ab_banks": True}),
    (["--compat", "--env", "circle_square"], {"compat": True}),
])
def test_emit_document_keys_equal_apx(monkeypatch, tmp_path, argv, mode):
    _, _, doc = _run_apx_main(monkeypatch, tmp_path, argv)
    calibration = 1.0 if set(mode) & {"real_banks", "deep"} else None
    ours = bench.emit_document({}, 4096, 1024, [], calibration, **mode)
    extra = {"omitted"} if "deep" in mode else set()
    assert list(ours) == list(doc) + sorted(extra)
    assert {k: ours[k] for k in mode} == {k: doc[k] for k in mode}


def test_fingerprint_and_record_keys_cover_apx(monkeypatch, tmp_path):
    """The port's fingerprint has apx's keys and the card's power limit,
    and a record apx's keys beside the port's fields (measurements and
    the card replaced by stand-ins here)."""
    _, _, doc = _run_apx_main(monkeypatch, tmp_path, ["--env", "circle_square"])
    card = {"device_kind": "card", "power_limit_w": 700.0, "nvidia_smi": "card, 700.00 W"}
    monkeypatch.setattr(bench, "_need_cuda", lambda what: CPU)
    monkeypatch.setattr(bench, "_card", lambda: card)
    fp = bench.fingerprint()
    assert set(doc["fingerprint"]) | {"power_limit_w", "nvidia_smi"} == set(fp)
    assert fp["platform"] == "gpu"
    stat_keys = ("obs_bytes_per_step", "device_busy_us_per_step",
                 "obs_hbm_roofline_us_per_step", "pct_of_obs_hbm_roofline", "assumed_hbm_gbps")

    def measure(lp, num_steps, g, stats=None, **kw):
        if stats is not None:
            stats.update(dict.fromkeys(stat_keys, 1.0))
        return 2.0, 1.0

    monkeypatch.setattr(bench, "_measure", measure)
    monkeypatch.setattr(bench, "_reset_cost", lambda lp, g: {"reset_ms": 1.0})
    rec = bench.bench_workload("circle_square", 8, 34)
    assert set(doc["results"][0]) - {"obs_probe"} <= set(rec)
    assert rec["value"] == 8 * 34 and rec["vs_baseline"] == 8 * 34 / 2200.0
    assert set(stat_keys) <= set(rec)
    rec = bench.bench_workload("lidar_maze", 8, 32)
    assert rec["baseline_kind"] == "none" and "vs_baseline" not in rec
    rec = bench.bench_workload("cifar10", 8, 17, bank_points=64)
    assert rec["bank_points"] == 64 and rec["bank_kind"] in ("synthetic", "huggingface")


def test_all_prints_one_record_per_workload(monkeypatch, capsys):
    monkeypatch.setattr(bench, "bench_workload",
                        lambda name, *a, **k: {"metric": f"{name}_env_steps_per_s", "value": 1})
    bench.main(["--all"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["metric"] for ln in lines] == [f"{n}_env_steps_per_s" for n in sorted(WORKLOADS)]
    assert set(jbench.BENCHES) | {"lidar_rooms_window"} == set(WORKLOADS)


@pytest.mark.parametrize("argv,message", [
    (["--key-impl", "rbg"], "--key-impl"),
    (["--glimpse-precision", "high"], "--glimpse-precision"),
    (["--deep", "--all"], "conflicts"),
    (["--deep", "--compat"], "conflicts"),
    (["--deep", "--env", "mnist"], "--env"),
    (["--deep", "--multihost"], "conflicts"),
    (["--compat", "--real-banks"], "--real-banks"),
    (["--compat", "--env", "lidar_rooms_window"], "--compat"),
    (["--ab-banks", "--bank-points", "100"], "--bank-points"),
    (["--multihost", "--all"], "--all"),
    (["--profile", "--emit", "x.json"], "--emit"),
])
def test_refused_flags(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_measurement_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--env", "lidar_maze", "--num-envs", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.fingerprint()


@pytest.mark.parametrize("name", sorted(COMPAT_IDS))
def test_compat_ids_build_and_step(name):
    """Every id of ``--compat --all`` builds as the adapter's core on the
    CPU and steps with the bench's actions."""
    from apx_torch.compat import make_core

    core = make_core(COMPAT_IDS[name], 4, device="cpu", rng="native")
    rng = np.random.default_rng(0)
    core.reset(seed=0)
    for _ in range(2):
        core.step(bench._compat_actions(core, rng))
