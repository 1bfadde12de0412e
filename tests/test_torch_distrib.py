"""apx_torch.distrib: env-batch sharding over torch.distributed (gloo on
the CPU), held to the one-process rollout bitwise and to apx's shardings
and ``episode_stats_psum``."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from apx.distrib import episode_stats_psum as apx_episode_stats_psum
from apx.distrib import make_env_mesh as apx_make_env_mesh

import apx_torch
from apx_torch.core.env import rollout, rollout_episodic
from apx_torch.distrib import (BankShard, EnvSharding, init_distributed, make_env_mesh,
                               shard_env_batch, shard_params, sharded_rollout,
                               sharded_vector_env_step)
from apx_torch.distrib.selftest import random_policy, state_digest

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 240


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group (a FileStore in tmp_path), destroyed
    after the test."""
    init_distributed(backend="gloo", device="cpu", init_method=f"file://{tmp_path}/store",
                     rank=0, world_size=1)
    yield make_env_mesh("cpu")
    dist.destroy_process_group()


# ---- (a) world 1: the sharded rollout is the rollout ------------------------

@pytest.mark.parametrize("env_id,n,steps,period", [
    ("LIDARLocRooms-v0", 8, 13, None),
    ("CircleSquare-v0", 8, 40, 16),  # episodic, two boundaries
    ("CircleSquare-v0", 8, 20, None),  # LOCKSTEP masked merge
    ("LightDark-v0", 8, 13, None),  # step draws
    ("LIDARLocRooms-sparse-v0", 8, 13, None),
])
def test_world1_sharded_rollout_equals_rollout(world1, env_id, n, steps, period):
    venv, params = apx_torch.make_vec(env_id, n, device="cpu")
    assert shard_params(world1, params) is params
    policy = random_policy(venv, params)
    state, mean, dones = sharded_rollout(venv, world1, params, policy, steps, period)(
        torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    if period is None:
        _, ref, (r, te, tr) = rollout(venv, params, policy, g, steps)
    else:
        _, ref, (r, te, tr) = rollout_episodic(venv, params, policy, g, steps, period)
    assert state_digest(state) == state_digest(ref)
    assert int(dones) == int((te | tr).sum())
    assert mean.dtype == torch.float64 and dones.dtype == torch.int64
    np.testing.assert_allclose(float(mean), float(r.double().mean()), rtol=1e-12)


def test_metrics_wrapped_sharded_rollout(world1):
    venv, params = apx_torch.make_vec("CircleSquare-v0", 8, device="cpu", metrics=True)
    policy = random_policy(venv, params)
    state, _, _ = sharded_rollout(venv, world1, params, policy, 34, 16)(
        torch.Generator().manual_seed(1))
    _, ref, _ = rollout_episodic(venv, params, policy, torch.Generator().manual_seed(1), 34, 16)
    assert state_digest(state) == state_digest(ref)


# ---- blocks of two ranks, no collective needed -------------------------------

@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LightDark-v0", "CircleSquare-v0"])
def test_sharded_step_is_the_block_of_the_step(env_id):
    n = 8
    venv, params = apx_torch.make_vec(env_id, n, device="cpu")
    policy = random_policy(venv, params)
    g = torch.Generator().manual_seed(2)
    _, state, _ = venv.reset(params, g)
    for _ in range(3):
        _, state, *_ = venv.step(state, policy(g, None), params, g)
    act = policy(g, None)
    after_policy = g.get_state()
    want = venv.step(state, act, params, g)
    for rank in range(2):
        sh = EnvSharding(rank, 2, torch.device("cpu"))
        g.set_state(after_policy)
        got = sharded_vector_env_step(venv, sh)(
            shard_env_batch(sh, state), shard_env_batch(sh, act), params, g)
        assert state_digest(got[:5]) == state_digest(shard_env_batch(sh, want[:5]))


# ---- (b) two worker processes over gloo --------------------------------------

def _workers(tmp_path, *args) -> list[dict]:
    store = tmp_path / "store"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "apx_torch.distrib.selftest", "--rank", str(r), "--world", "2",
         "--init", f"file://{store}", "--device", "cpu", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        lines.append(json.loads(next(ln for ln in out.splitlines()
                                     if ln.startswith("SELFTEST "))[len("SELFTEST "):]))
    return lines


@pytest.mark.parametrize("env_id,steps,period", [
    ("LIDARLocRooms-v0", 13, None),
    ("CircleSquare-v0", 40, 16),
])
def test_two_gloo_ranks_equal_the_solo_run(tmp_path, env_id, steps, period):
    n = 16
    args = ["--env", env_id, "--num-envs", str(n), "--steps", str(steps), "--seed", "7"]
    if period is not None:
        args += ["--episodic-period", str(period)]
    res = _workers(tmp_path, *args)
    solo = res[0]["solo"]
    for r, out in enumerate(res):
        assert out["rank"] == r and out["backend"] == "gloo" and out["block"] == [8 * r, 8 * r + 8]
        assert out["digest"] == solo["digests"][r]
        assert out["done_count"] == solo["done_count"]
        np.testing.assert_allclose(out["mean_reward"], solo["mean_reward"], rtol=1e-6)
    if period is not None:
        assert solo["done_count"] == 2 * n  # two LOCKSTEP boundaries in 40 steps


@pytest.mark.parametrize("env_id,steps,period", [
    ("LIDARLocRooms-v0", 13, None),
    ("CircleSquare-v0", 40, 16),  # an image bank
])
def test_two_gloo_ranks_with_a_sharded_bank(tmp_path, env_id, steps, period):
    """The bank sharded over two gloo ranks (``--shard-bank``): each rank's
    block of the final state bitwise the replicated solo run's, and each
    rank holds only its block of every bank leaf, bitwise the whole bank's
    rows [rM/2, (r+1)M/2) (after apx's test_host_sharded_bank_matches_replicated),
    in storage of the block's size: the whole bank is never allocated for
    the shard."""
    n = 16
    args = ["--env", env_id, "--num-envs", str(n), "--steps", str(steps), "--seed", "7",
            "--shard-bank"]
    if period is not None:
        args += ["--episodic-period", str(period)]
    res = _workers(tmp_path, *args)
    solo = res[0]["solo"]
    for r, out in enumerate(res):
        assert out["digest"] == solo["digests"][r]
        assert out["done_count"] == solo["done_count"]
        bank = out["bank"]
        m = bank["num_rows"]
        assert bank["rows"] == [r * m // 2, (r + 1) * m // 2]
        assert set(bank["leaf_rows"].values()) == {m // 2}
        assert bank["digest"] == solo["bank_digests"][r]
        assert bank["storage_bytes"] == bank["leaf_bytes"]
        assert 2 * bank["leaf_bytes"] == bank["whole_bank_bytes"]
        assert bank["device_bytes_added"] is None  # measured on a card only
        assert bank["bytes_per_step"] > 0


# ---- (c) the blocks are apx's P("env") shards ---------------------------------

@pytest.mark.parametrize("world", [2, 4, 8])
def test_blocks_equal_apx_env_shards(world):
    n = 32
    mesh = apx_make_env_mesh(world)
    x = jax.device_put(jnp.arange(n), NamedSharding(mesh, P("env")))
    shards = sorted(x.addressable_shards, key=lambda s: mesh.devices.tolist().index(s.device))
    t = torch.arange(n)
    for rank, shard in enumerate(shards):
        sh = EnvSharding(rank, world, torch.device("cpu"))
        block = sh.block(n)
        assert shard.index[0] == block
        tree = shard_env_batch(sh, {"x": t, "y": (t * 2, t[:, None].repeat(1, 3))})
        np.testing.assert_array_equal(tree["x"].numpy(), np.asarray(shard.data))
        assert tree["y"][1].shape == (n // world, 3)


def test_uneven_batch_raises():
    with pytest.raises(ValueError, match="does not split evenly"):
        EnvSharding(0, 3, torch.device("cpu")).local(torch.zeros(16))


# ---- (d) episode_stats_psum over two gloo ranks vs apx's shard_map ------------

_STATS_SCRIPT = """
import json, sys
import numpy as np, torch
from apx_torch.distrib import (init_distributed, make_env_mesh, shard_env_batch, all_sum,
                               all_mean, episode_stats_psum)
rank, store, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
init_distributed(backend="gloo", device="cpu", init_method="file://" + store, rank=rank,
                 world_size=2)
sh = make_env_mesh("cpu")
z = np.load(data)
stats = shard_env_batch(sh, {k[len("s_"):]: torch.from_numpy(z[k]) for k in z.files
                             if k.startswith("s_")})
done = sh.local(torch.from_numpy(z["done"]))
out = episode_stats_psum(stats, done)
s, m = all_sum(torch.tensor([rank + 1.0])), all_mean(torch.tensor([rank + 1.0]))
torch.distributed.destroy_process_group()
if rank == 0:
    print("STATS " + json.dumps({**{k: float(v) for k, v in out.items()},
                                  "all_sum": float(s), "all_mean": float(m)}))
"""


def test_episode_stats_psum_matches_apx(tmp_path):
    from jax import shard_map

    n = 16
    rng = np.random.default_rng(0)
    done = rng.random(n) < 0.5
    done[:2] = True
    stats = {
        "avg_mse": np.where(done, rng.random(n) * 3, np.nan).astype(np.float32),
        "final_prob": np.where(done, rng.random(n), np.nan).astype(np.float32),
        "_avg_mse": done.copy(),  # private: skipped
        "lengths": rng.integers(1, 16, n).astype(np.int32),  # not a float: skipped
    }
    mesh = apx_make_env_mesh(2)
    ref = shard_map(lambda s, d: apx_episode_stats_psum(s, d), mesh=mesh,
                    in_specs=(P("env"), P("env")), out_specs=P())(
        {k: jnp.asarray(v) for k, v in stats.items()}, jnp.asarray(done))
    data = tmp_path / "stats.npz"
    np.savez(data, done=done, **{f"s_{k}": v for k, v in stats.items()})
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _STATS_SCRIPT, str(r),
                               str(tmp_path / "store"), str(data)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    got = json.loads(next(ln for ln in outs[0][0].splitlines()
                          if ln.startswith("STATS "))[len("STATS "):])
    assert set(got) == set(ref) | {"all_sum", "all_mean"}
    assert got["episodes"] == float(ref["episodes"]) == done.sum()
    for k in ("avg_mse", "final_prob"):
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-6, atol=1e-6)
    assert got["all_sum"] == 3.0 and got["all_mean"] == 1.5


# ---- (e) init, mesh and params ----------------------------------------------

def test_init_distributed_is_idempotent(world1, tmp_path):
    group = dist.group.WORLD
    init_distributed(backend="gloo", device="cpu", init_method=f"file://{tmp_path}/other",
                     rank=0, world_size=1)
    assert dist.group.WORLD is group and dist.get_world_size() == 1
    assert world1 == EnvSharding(0, 1, torch.device("cpu"))


def test_shard_leading_raises(world1):
    """``shard_leading=True`` is accepted, as apx's: on one rank the bank
    keeps all its rows, fetched through the collective, and the rollout is
    the replicated one; a bank whose rows do not split over the ranks
    raises, as apx's ``device_put`` of an uneven leading axis does."""
    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", 4, device="cpu")
    sharded = shard_params(world1, params, shard_leading=True)
    bank = sharded.map_bank
    assert sharded is not params and bank.shard is not None and params.map_bank.shard is None
    assert (bank.shard.lo, bank.shard.hi, bank.num_maps) == (0, 256, 256)
    policy = random_policy(venv, params)
    runs = [sharded_rollout(venv, world1, p, policy, 13)(torch.Generator().manual_seed(3))
            for p in (params, sharded)]
    assert state_digest(runs[0][0]) == state_digest(runs[1][0])
    with pytest.raises(ValueError, match="split evenly"):
        BankShard(EnvSharding(0, 3, torch.device("cpu")), 256)
    with pytest.raises(ValueError, match="split evenly"):
        shard_params(world1, params, shard_leading=True).map_bank.sharded(
            BankShard(EnvSharding(1, 3, torch.device("cpu")), 256))


def test_shard_leading_places_blocks_not_the_bank(world1, monkeypatch):
    """``shard_leading=True`` never broadcasts the caller's bank in place:
    each leaf with a bank axis becomes a copy of its block, sent block by
    block, the beam tables stay whole, and the bench's sharded loop builds
    its bank on the host and runs on the rank's device."""
    from apx_torch.bench import _loop
    from apx_torch.distrib import mesh

    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", 4, device="cpu")
    params = dataclasses.replace(params, map_bank=params.map_bank.with_beam_tables())
    sent = []
    real = mesh.dist.broadcast
    monkeypatch.setattr(mesh.dist, "broadcast",
                        lambda t, **kw: (sent.append(t.data_ptr()), real(t, **kw))[1])
    bank = params.map_bank
    sharded = shard_params(world1, params, shard_leading=True).map_bank
    rows = ("maps", "indices", "free_counts", "row_words", "free_cells")
    assert not {getattr(bank, f).data_ptr() for f in rows} & set(sent)
    assert len(sent) == len(rows) + 2  # one block per leaf (world 1), the two tables
    for f in rows:
        leaf = getattr(sharded, f)
        assert leaf.data_ptr() != getattr(bank, f).data_ptr()
        assert leaf.untyped_storage().nbytes() == leaf.nbytes
        assert torch.equal(leaf, getattr(bank, f))
    assert torch.equal(sharded.beam_face, bank.beam_face)
    lp = _loop("lidar_rooms", 4, torch.device("cpu"), overrides={"shard_bank": True},
               sharding=world1)
    assert lp.params.map_bank.shard is not None and lp.params.device == world1.device


def test_no_silent_fallback(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_env_mesh("cpu")
    if not dist.is_nccl_available():  # a CPU build: nccl fails and nothing else is tried
        with pytest.raises((RuntimeError, ValueError)):
            init_distributed(device="cuda", init_method=f"file://{tmp_path}/s", rank=0,
                             world_size=1)
        assert not dist.is_initialized()
    if not torch.cuda.is_available():
        init_distributed(backend="gloo", device="cpu", init_method=f"file://{tmp_path}/g",
                         rank=0, world_size=1)
        try:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make_env_mesh("cuda")
        finally:
            dist.destroy_process_group()
