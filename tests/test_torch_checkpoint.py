"""apx_torch.utils.checkpoint: a rollout saved after k steps and restored
into a fresh state continues bitwise as the uninterrupted run; a
checkpoint that does not match the state it restores raises."""

import dataclasses

import pytest
import torch

import apx_torch
from apx_torch.core.env import VectorState
from apx_torch.utils.checkpoint import restore_state, save_state

torch.set_num_threads(1)

N = 8


def _act(g, venv, params):
    k = venv.env.prediction_space(params).shape[-1]
    return {"action": torch.rand((N, 2), generator=g) * 2 - 1,
            "prediction": torch.randn((N, k), generator=g)}


def _leaves(tree) -> list[torch.Tensor]:
    out = []
    apx_torch.core.env.tree_map(out.append, tree)
    return out


def _steps(venv, params, obs, state, g, m):
    outs = []
    for _ in range(m):
        obs, state, *rest = venv.step(state, _act(g, venv, params), params, g)
        outs.append((obs, state, *rest))
    return outs


@pytest.mark.parametrize("env_id,metrics,k,m", [
    ("LIDARLocRooms-v0", False, 95, 10),  # NEXT_STEP, through the 100-step limit
    ("CircleSquare-v0", True, 10, 30),  # LOCKSTEP, ring buffers, two boundaries
    ("LightDark-v0", False, 45, 10),  # step draws, through the 50-step limit
])
def test_resume_is_bitwise(env_id, metrics, k, m, tmp_path):
    path = tmp_path / "ckpt.pt"
    venv, params = apx_torch.make_vec(env_id, N, device="cpu", metrics=metrics)
    g = torch.Generator().manual_seed(3)
    obs, state, _ = venv.reset(params, g)
    for o in _steps(venv, params, obs, state, g, k):
        obs, state = o[:2]
    save_state(str(path), {"obs": obs, "state": state, "generator": g.get_state()})
    want = _steps(venv, params, obs, state, g, m)
    dones = sum(int((o[3] | o[4]).sum()) for o in want)
    assert dones > 0  # the continuation crosses episode ends

    venv2, params2 = apx_torch.make_vec(env_id, N, device="cpu", metrics=metrics)
    g2 = torch.Generator().manual_seed(99)
    obs2, like, _ = venv2.reset(params2, g2)
    got = restore_state(str(path), {"obs": obs2, "state": like, "generator": g2.get_state()})
    assert type(got["state"]) is type(state)
    g2.set_state(got["generator"])
    got = _steps(venv2, params2, got["obs"], got["state"], g2, m)
    for t, (a, b) in enumerate(zip(_leaves(want), _leaves(got), strict=True)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), t


def _saved_lidar(tmp_path, n=N):
    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    _, state, _ = venv.reset(params, torch.Generator().manual_seed(0))
    path = str(tmp_path / f"s{n}.pt")
    save_state(path, {"state": state, "step": torch.tensor(3)})
    return path, state


def test_mismatched_structure_raises(tmp_path):
    path, state = _saved_lidar(tmp_path)
    with pytest.raises(ValueError, match="keys"):
        restore_state(path, {"state": state})
    with pytest.raises(ValueError, match="saved a VectorState|saved a .*VectorState"):
        restore_state(path, {"state": state.inner, "step": torch.tensor(0)})
    other = dataclasses.replace(state, prev_done=None)
    with pytest.raises(ValueError, match="prev_done: saved a tensor, expected a none"):
        restore_state(path, {"state": other, "step": torch.tensor(0)})


def test_mismatched_shape_raises(tmp_path):
    path, _ = _saved_lidar(tmp_path)
    _, small = _saved_lidar(tmp_path, n=4)
    with pytest.raises(ValueError, match=r"shape \(8, 32, 32\), expected \(4, 32, 32\)"):
        restore_state(path, {"state": small, "step": torch.tensor(0)})


def test_mismatched_dtype_raises(tmp_path):
    path, state = _saved_lidar(tmp_path)
    env_state = state.inner.inner
    inner = dataclasses.replace(state.inner, inner=dataclasses.replace(
        env_state, pos=env_state.pos.double()))
    like = {"state": VectorState(inner=inner, prev_done=state.prev_done), "step": torch.tensor(0)}
    with pytest.raises(ValueError, match="state.inner.inner.pos: saved dtype torch.float32, "
                                         "expected torch.float64"):
        restore_state(path, like)


def test_leaves_land_on_like_devices(tmp_path):
    path, state = _saved_lidar(tmp_path)
    got = restore_state(path, {"state": state, "step": torch.tensor(0)})
    assert int(got["step"]) == 3
    for a, b in zip(_leaves(got), _leaves({"state": state, "step": torch.tensor(3)})):
        assert a.device == b.device and torch.equal(a, b)
