"""The recipes on a (data, model) grid of gloo ranks on the CPU, each held
to its one-process run (after apx's ``test_mesh_ppo_trains_dp_tp``,
``test_mesh_vtrace_trains`` and ``test_mesh_r2d2_trains``), the dry run
(``apx_torch.graft_entry``) and the two small examples. The ranks are
spawned as ``tests/test_torch_distrib.py`` spawns its ranks."""

import json
import math

import numpy as np
import pytest
import torch

from apx_torch.distrib.mesh import EnvSharding
from apx_torch.examples.train_ppo_mesh import Grid, spawn_grid, trunk_rows
from apx_torch.graft_entry import dryrun_multichip, entry

torch.set_num_threads(1)
WORKER_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def grid_runs():
    """Four gloo ranks, a 2 (data) x 2 (model) grid: one PPO iteration, two
    V-trace and two R2D2 iterations at N = 16, rollout 4."""
    outs = spawn_grid("apx_torch.examples.grid_selftest", 4, "cpu", "gloo",
                      ["--num-envs", "16", "--rollout-len", "4"], timeout=WORKER_TIMEOUT_S)
    return [json.loads(next(ln for ln in out.splitlines() if ln.startswith("GRIDTEST "))[9:])
            for out in outs]


def test_grid_layout(grid_runs):
    for r, out in enumerate(grid_runs):
        assert out["rank"] == r and out["backend"] == "gloo"
        assert out["grid"] == [2, 2] and out["place"] == [r // 2, r % 2]


def test_mesh_ppo_equals_the_one_process_run(grid_runs):
    """The first rollout runs under equal nets: the mean rewards agree to
    rtol 1e-5; the updated trunk rows admit reduction-order drift, 2e-5."""
    for out in grid_runs:
        ppo = out["ppo"]
        np.testing.assert_allclose(ppo["mean_reward"], ppo["solo_mean_reward"], rtol=1e-5)
        assert ppo["trunk_max_abs_diff"] <= 2e-5, ppo


def test_each_rank_holds_only_its_trunk_rows(grid_runs):
    for out in grid_runs:
        assert out["ppo"]["trunk_shape"] == [256, 128]  # (out, this rank's 128 input rows)
        assert out["vtrace"]["trunk_shape"] == [256, 128]
        assert out["r2d2"]["trunk_shape"] == [256, 128]


def test_mesh_vtrace_syncs_its_behavior_net(grid_runs):
    for out in grid_runs:
        vt = out["vtrace"]
        assert vt["iters"] == 2 and vt["sync_every"] == 2
        assert all(math.isfinite(r) for r in vt["rewards"])
        assert vt["behavior_equals_learner"]
    assert len({tuple(out["vtrace"]["rewards"]) for out in grid_runs}) == 1


@pytest.mark.parametrize("recipe", ["vtrace", "r2d2"])
def test_mesh_offpolicy_equals_the_one_process_run(grid_runs, recipe):
    """Two iterations of each off-policy learner on the grid against the
    same two in one process (itself held against apx's iterations in
    ``test_torch_train_offpolicy.py``): every mean reward within rtol 1e-5,
    the trunk rows' gradient of the first iteration (equal nets) within
    1e-5 of its largest entry (the weights after Adam's steps are reported,
    not held: Adam amplifies the rounding of gradients near its eps,
    ``trunk_grad_diff``)."""
    for out in grid_runs:
        res = out[recipe]
        np.testing.assert_allclose(res["rewards"], res["solo_rewards"], rtol=1e-5)
        assert res["trunk_grad_rel_diff"] <= 1e-5, res


def test_mesh_r2d2_ring_and_target_sync(grid_runs):
    for out in grid_runs:
        rd = out["r2d2"]
        assert rd["ptr"] == rd["filled"] == 2
        assert rd["target_equals_online"]
        assert rd["ring_envs"] == 8  # the ring holds this data rank's block of 16
        assert all(math.isfinite(r) for r in rd["rewards"])


def test_trunk_rows_meet_the_local_activations():
    """Model rank m holds apx's ``trunk.w`` rows [m-th block of the prop
    half, 128 + m-th block of the map half], not GSPMD's contiguous half."""
    def grid(m, model):
        return Grid(data=1, model=model, d=0, m=m, device=torch.device("cpu"), data_group=None,
                    model_group=None, env=EnvSharding(0, 1, torch.device("cpu")))

    assert torch.equal(trunk_rows(grid(0, 1)), torch.arange(256))
    assert torch.equal(trunk_rows(grid(1, 2)),
                       torch.cat([torch.arange(64, 128), torch.arange(192, 256)]))
    both = torch.cat([trunk_rows(grid(0, 2)), trunk_rows(grid(1, 2))])
    assert torch.equal(both.sort().values, torch.arange(256))


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip(world):
    """The dry run's three checks on 1 x 2 and 2 x 2 grids: the sharded
    rollouts equal the one-process ones (done counts, mean rewards rtol
    1e-5) and the sharded training step's loss and SGD step the
    one-process ones (the step within 1e-5 of its largest entry)."""
    ranks = dryrun_multichip(world, "cpu", "gloo")
    assert [r["rank"] for r in ranks] == list(range(world))
    for r in ranks:
        ts = r["train_step"]
        np.testing.assert_allclose(ts["loss"], ts["solo_loss"], rtol=1e-5)
        assert ts["step_rel_diff"] <= 1e-5, ts
        assert math.isfinite(ts["loss"]) and ts["finite"]
        assert ts["hidden"] == 16 and ts["w1_shape"] == [267, 8]
        for name in ("lidar", "episodic"):
            assert r[name]["done_count"] == r[name]["solo_done_count"]
            np.testing.assert_allclose(r[name]["mean_reward"], r[name]["solo_mean_reward"],
                                       rtol=1e-5)


def test_entry_flagship_step():
    """The flagship CircleSquare step (16x16, N = 64): at zero logits the
    normalized cross-entropy is 1 and the base reward -1e-3 |a| is 0."""
    fn, (g, state, act, params) = entry("cpu")
    obs, state2, reward, term, trunc = fn(g, state, act, params)
    assert obs["glimpse"].shape == (64, 5, 5, 1)
    assert float(obs["glimpse"].min()) >= 0.0 and float(obs["glimpse"].max()) <= 1.0
    assert torch.allclose(reward, torch.full((64,), -1.0), atol=1e-6)
    assert not term.any() and not trunc.any()


def test_gym_compat_example_matches_apx():
    """The drop-in example's seeded stream: the port's summed reward equals
    apx.compat's (the reference-mode episodes are bitwise; the rewards'
    log-softmax within 1e-6 each)."""
    pytest.importorskip("gymnasium")
    import apx.compat as apc
    from apx_torch.examples.gym_compat import run

    env = apc.make("CircleSquare-v0")
    rng = np.random.default_rng(0)
    env.reset(seed=0)
    total = 0.0
    for _ in range(64):
        action = {"action": rng.uniform(-1, 1, env.action_space["action"].shape).astype(np.float32),
                  "prediction": rng.normal(size=env.prediction_space.shape).astype(np.float32)}
        total += float(env.step(action)[1])
    assert run("CircleSquare-v0", 64, device="cpu", quiet=True) == pytest.approx(total, abs=64e-6)


def test_rollout_functional_example():
    from apx_torch.examples.rollout_functional import run

    res = run("CircleSquare-v0", 8, 40, device="cpu")
    assert res["episodes"] == 2 * 8  # two 16-step episodes and their LOCKSTEP resets
    assert -1.5 < res["mean_reward"] < 0 and 0 <= res["metric"] <= 1
    res = run("LIDARLocRooms-v0", 8, 3, device="cpu")
    assert math.isfinite(res["mean_reward"]) and res["episodes"] == 0
