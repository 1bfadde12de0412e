"""The plain references held against the port (``apx_torch``, its plain
forms on the CPU) at a tiny size. The test imports both; the reference
imports neither the port nor the JAX package."""

import numpy as np
import pytest
import torch

import apx_torch
from apx_torch.core.env import AutoResetMode, vector_env, with_autoreset
from apx_torch.data.dataset import BankImageDataset
from apx_torch.data.floor_map import bank_from_maps
from apx_torch.envs.image_localization import ImageLocalizationEnv
from apx_torch.ops.glimpse import extract_glimpse_batch

from benchmark import manifest
from benchmark.data.rooms import rooms_bank
from benchmark.families import lidar as lidar_family
from benchmark.reference import image_loc as ref_image
from benchmark.reference import lidar as ref_lidar
from benchmark.yardstick.judge import departures

N = 32
TOL = 1e-3


def _lidar(seed):
    maps, idx = rooms_bank(0, 8)
    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", N, device="cpu",
                                      map_bank=bank_from_maps(maps, idx, "rooms", "cpu"))
    return venv, params, ref_lidar.Bank(torch.from_numpy(maps), torch.from_numpy(idx)), \
        torch.Generator().manual_seed(seed)


def test_references_state_the_configurations():
    lidar = manifest.cell(manifest.load(), "lidar_rooms.rollout")["config"]
    assert (ref_lidar.BEAMS, ref_lidar.LIDAR_RANGE, ref_lidar.TIME_LIMIT) == \
        (lidar["beams"], lidar["lidar_range"], lidar["time_limit"])
    image = manifest.cell(manifest.load(), "tin_loc.rollout")["config"]
    assert (ref_image.STEP_LIMIT, ref_image.MAX_STEP, list(ref_image.SENSOR)) == \
        (image["step_limit"], image["max_step_length"], image["sensor_size"])


def test_rooms_maps_are_the_ports():
    from apx_torch.data.floor_map import make_rooms_bank

    maps, idx = rooms_bank(0, 4)
    bank = make_rooms_bank(4, seed=0, device="cpu")
    assert np.array_equal(bank.maps.numpy(), maps)
    assert np.array_equal(bank.indices.numpy(), idx)


def test_bank_free_cells_are_row_major():
    maps = torch.tensor([[[True, False], [False, True]]])
    bank = ref_lidar.Bank(maps, torch.tensor([7]))
    assert bank.free_counts.tolist() == [2]
    assert bank.free_cells[0, :2].tolist() == [1, 2]


@pytest.mark.parametrize("seed", [1, 2])
def test_lidar_reset_and_steps(seed):
    """The reset, then 104 steps, each from the program's state: through
    the time limit's termination at step 100 and the resets after it."""
    venv, params, bank, g = _lidar(seed)
    offsets = ref_lidar.beam_offsets()
    draws = venv.env.draw_reset(N, params, g)
    obs, state, _ = venv.reset(params, draws=draws)
    env = lidar_family.Env(venv, params, N, 1, bank, offsets, N)
    bad, _ = departures(lidar_family.program_leaves(obs, state),
                        lidar_family.reference_reset(env, draws, torch.float64), TOL)
    assert not bad.any()
    resets = 0
    for _ in range(104):
        before = lidar_family.program_leaves(obs, state)
        rs = {k: before[k].double() if before[k].is_floating_point() else before[k].long()
              if k == "t" else before[k] for k in lidar_family.STATE_KEYS}
        resets += int(rs["prev_done"].sum())
        act = torch.rand((N, 2), generator=g) * 2.5 - 1.25
        pred = torch.randn((N, 2), generator=g)
        rd = venv.env.draw_reset(N, params, g)
        r_obs, r_state, r_rew, r_term, r_trunc = ref_lidar.vector_step(
            rs, act, pred, bank, rd["bank_pos"], rd["k"], offsets)
        obs, state, rew, term, trunc, _ = venv.step(state, {"action": act, "prediction": pred},
                                                    params, reset_draws=rd, step_draws={})
        bad, report = departures(
            {**lidar_family.program_leaves(obs, state), "reward": rew, "term": term,
             "trunc": trunc},
            {**lidar_family._leaves(r_obs, r_state), "reward": r_rew, "term": r_term,
             "trunc": r_trunc}, TOL)
        assert not bad.any(), report
    assert resets >= N


def test_glimpse_matches_the_plain_form():
    g = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (16, 64, 64, 3), generator=g, dtype=torch.uint8)
    pos = torch.rand((16, 2), generator=g) * 2.2 - 1.1
    ours = ref_image.glimpse(images, pos.double())
    theirs = extract_glimpse_batch(images, pos, (10, 10))
    assert (ours - theirs.double()).abs().max() < 1e-5


@pytest.mark.parametrize("seed", [4, 5])
def test_image_episode(seed):
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (64, 64, 64, 3), generator=g, dtype=torch.uint8)
    labels = torch.randint(0, 200, (64,), generator=g)
    env = ImageLocalizationEnv(dataset=BankImageDataset(images, labels, 200), sensor_size=(10, 10))
    params = env.default_params()
    venv = vector_env(env, N, AutoResetMode.LOCKSTEP)
    inner = with_autoreset(venv, AutoResetMode.DISABLED)
    _, state, _ = venv.reset(params, g)
    old_target = state.inner.target.double()
    d = env.draw_reset(N, params, g)
    pred = torch.randn((N, 2), generator=g)
    obs, state, rew, term, _, _ = venv.boundary_reset_step(
        state, {"action": torch.zeros((N, 2)), "prediction": pred}, params, reset_draws=d,
        step_draws={})
    r_obs, r_state, r_rew, r_term, _ = ref_image.boundary_step(
        images, {"target": old_target, "pos": old_target,
                 "prev_done": torch.ones(N, dtype=torch.bool)},
        pred, d["index"], d["pos"], d["target"])
    for _ in range(16):
        assert (rew.double() - r_rew).abs().max() < TOL and torch.equal(term, r_term)
        for k in r_obs:
            assert (obs[k].double() - r_obs[k]).abs().max() < TOL, k
        act = torch.rand((N, 2), generator=g) * 2.4 - 1.2
        pred = torch.randn((N, 2), generator=g)
        obs, state, rew, term, _, _ = inner.step(state, {"action": act, "prediction": pred},
                                                 params, step_draws={})
        r_obs, r_state, r_rew, r_term, _ = ref_image.step(images, r_state, act, pred)
    assert term.all() and r_term.all()
    assert (state.inner.perception.pos.double() - r_state["pos"]).abs().max() < TOL
