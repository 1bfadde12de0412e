"""TinyImageNet-v0 on the CPU against the benchmark's plain reference
(``benchmark/reference/image_cls.py``, float64, written from ap_gym's
semantics and independent of the port): three LOCKSTEP cycles (the
boundary reset, then 16 steps) over a seeded bank of 512 images, with
logits of scale up to +-80 in some envs so that the log-softmax is tested
where it must be stable. The boundary's loss is against the new image's
label; the reference computed in bfloat16 departs; the id's registry entry
builds the configuration's parameters."""

import math

import pytest
import torch

import apx_torch
from apx_torch.core.env import AutoResetMode
from apx_torch.core.losses import AffineLossFn, CrossEntropyLossFn
from apx_torch.data.dataset import BankImageDataset
from benchmark import manifest
from benchmark.families import image_cls as family
from benchmark.kinds import rollout
from benchmark.reference import image_cls as ref
from benchmark.yardstick.judge import departures

N = 32
BANK = 512
CYCLES = 3
TOL = 1e-5


def _cell():
    cell = manifest.cell(manifest.load(), "tin_cls.rollout")
    config = {**cell["config"], "bank_images": BANK}
    traffic = {**cell["traffic"], "num_envs": N, "check_block_envs": N // 2}
    return cell, config, traffic


def _env(seed):
    _, config, traffic = _cell()
    return family.build(config, traffic, seed, torch.device("cpu"))


def _draws(env, g):
    """A chunk's draws, the logits of envs 0, 4, 8, ... spread to about
    +-80, of envs 1, 5, ... shifted by +80 and of envs 2, 6, ... by -80."""
    draws = family.draw_pool(env, g, env.chunk)
    p = draws["prediction"]
    p[:, 0::4] *= 25.0
    p[:, 1::4] += 80.0
    p[:, 2::4] -= 80.0
    return draws


def _gap(a, b):
    return float((a.double() - b.double()).abs().max())


def _check(leaves, want, what, sum_tol=TOL):
    for key, w in want.items():
        got = leaves[key]
        if w.is_floating_point():
            tol = sum_tol if key == "reward_sum" else TOL
            assert _gap(got, w) <= tol, (what, key, _gap(got, w))
        else:
            assert torch.equal(got.long(), w.long()), (what, key)


@pytest.mark.parametrize("seed", [0, 1])
def test_cycles_follow_the_reference(seed):
    """Each step's obs, state, reward and loss within 1e-5 of the float64
    reference; the family's chunk (``step_chunk``) gives the same leaves
    and reward sums as the reference's chunk."""
    env = _env(seed)
    g = torch.Generator().manual_seed(100 + seed)
    policy = rollout.policy
    obs, state, lead = family.initial_reset(env, g, policy)
    _check(family.program_leaves(obs, state), family.reference_reset(env, lead, torch.float64),
           "lead")
    for cycle in range(CYCLES):
        draws = _draws(env, g)
        racc = torch.zeros(N)
        dacc = torch.zeros(N, dtype=torch.int32)
        c_obs, c_state = family.step_chunk(env, obs, state, draws, racc, dacc, policy)
        want = family.reference_chunk(env, None, draws, None, torch.float64, policy)
        # The sums: 17 rewards of up to ~35 added in float32.
        _check({**family.program_leaves(c_obs, c_state), "reward_sum": racc, "term_count": dacc},
               want, f"chunk {cycle}", sum_tol=1e-4)
        assert int(dacc.sum()) == N  # every episode ends on the chunk's last step
        # Step by step, as the chunk steps: rewards and the info's loss.
        for j in range(env.chunk):
            pred = draws["prediction"][j]
            full = {"action": policy(draws["action"][j], obs), "prediction": pred}
            if j == 0:
                old_label = state.inner.label.clone()
                obs, state, reward, term, trunc, info = env.venv.boundary_reset_step(
                    state, full, env.params, reset_draws=family._reset_draws(draws, 0),
                    step_draws={})
                r_obs, r_state, r_rew, r_term, r_trunc = ref.boundary_step(
                    env.images, env.labels, pred, draws["index"][0], draws["pos"][0],
                    torch.float64)
                new_label = env.labels[draws["index"][0]]
                assert torch.equal(info["prediction"]["target"], new_label)
                old_ce = ref.cross_entropy(pred, old_label, torch.float64)
                # Against the old label the loss would differ: by more than
                # 1e-3 in nearly every env whose label changed.
                moved = new_label != old_label
                apart = (info["prediction"]["loss"].double() - old_ce).abs() > 1e-3
                assert int((apart & moved).sum()) >= 0.75 * N
            else:
                obs, state, reward, term, trunc, info = env.inner.step(
                    state, full, env.params, step_draws={})
                r_obs, r_state, r_rew, r_term, r_trunc = ref.step(
                    env.images, env.labels, r_state, full["action"], pred)
            ce = ref.cross_entropy(pred, env.labels[r_state["data_index"]], torch.float64)
            assert _gap(info["prediction"]["loss"], ce) <= TOL, (cycle, j)
            assert _gap(reward, r_rew) <= TOL, (cycle, j)
            assert torch.equal(term, r_term) and torch.equal(trunc, r_trunc)
            _check(family.program_leaves(obs, state), {**r_obs, **r_state}, (cycle, j))
        # The stepwise loop and the chunk end in the same state.
        assert torch.equal(state.inner.pos, c_state.inner.pos)


def test_logits_reach_80_and_the_loss_stays_finite():
    env = _env(2)
    g = torch.Generator().manual_seed(7)
    draws = _draws(env, g)
    assert float(draws["prediction"][:, 0::4].abs().max()) > 60.0
    label = env.labels[draws["index"][0]]
    for j in range(env.chunk):
        loss = env.venv.env.loss_fn(env.params)(draws["prediction"][j], label)
        assert torch.isfinite(loss).all()
        assert _gap(loss, ref.cross_entropy(draws["prediction"][j], label, torch.float64)) <= TOL


def test_bfloat16_reference_departs():
    env = _env(3)
    g = torch.Generator().manual_seed(8)
    draws = family.draw_pool(env, g, env.chunk)
    policy = rollout.policy
    want = family.reference_chunk(env, None, draws, None, torch.float64, policy)
    low = family.reference_chunk(env, None, draws, None, torch.bfloat16, policy)
    bad, report = departures(low, want, 1e-3)
    assert float(bad.float().mean()) > 0.9, report
    assert report["reward_sum"]["departing"] > N // 2


def test_registry_entry_states_the_configuration(monkeypatch):
    """``apx_torch.make_vec("TinyImageNet-v0")`` over a CPU bank (the
    corpus' loader replaced by a seeded bank of its geometry) builds the
    parameters, the autoreset and the loss that the configuration states,
    and the family builds the same."""
    from apx_torch import registry
    from apx_torch.data.huggingface import HF_DATASET_GEOMETRY

    cell, config, traffic = _cell()
    asked = []
    g = torch.Generator().manual_seed(9)
    h, w, c = config["image_shape"]
    bank = BankImageDataset(torch.randint(0, 256, (BANK, h, w, c), generator=g,
                                          dtype=torch.uint8),
                            torch.randint(0, config["classes"], (BANK,), generator=g),
                            config["classes"])

    def hf_bank(name, split, device, **kw):
        asked.append((name, split, str(device)))
        return bank

    monkeypatch.setattr(registry, "_hf_bank", hf_bank)
    venv, params = apx_torch.make_vec(config["env_id"], N, device="cpu")
    assert asked == [("zh-plus/tiny-imagenet", "train", "cpu")]
    geometry = HF_DATASET_GEOMETRY["zh-plus/tiny-imagenet"]
    assert (list(geometry.image_hw) + [geometry.channels], geometry.num_classes,
            geometry.split_sizes["train"]) == \
        (config["image_shape"], config["classes"], cell["config"]["bank_images"])
    built = family.build(config, traffic, 0, torch.device("cpu")).params
    for p in (params, built):
        assert list(p.sensor_size) == config["sensor_size"] == list(ref.SENSOR)
        assert p.step_limit == config["step_limit"] == ref.STEP_LIMIT
        assert tuple(p.max_step_length) == (config["max_step_length"],) * 2
        assert p.max_step_length[0] == ref.MAX_STEP
        assert p.randomly_invert_labels is False and p.sensor_scale == 1.0
        assert p.dataset.num_classes == config["classes"] == ref.CLASSES
    assert venv.autoreset is AutoResetMode.LOCKSTEP and config["autoreset"] == "lockstep"
    loss_fn = venv.env.loss_fn(params)
    assert isinstance(loss_fn, AffineLossFn) and isinstance(loss_fn.inner, CrossEntropyLossFn)
    assert math.isclose(loss_fn.scale, 1.0 / math.log(config["classes"])) and \
        loss_fn.offset == 0.0


def test_build_refuses_other_constants():
    _, config, traffic = _cell()
    for change in ({"sensor_size": [5, 5]}, {"step_limit": 32}, {"max_step_length": 0.1},
                   {"classes": 10}):
        with pytest.raises(ValueError, match="the reference"):
            family.build({**config, **change, "bank_images": 8}, traffic, 0,
                         torch.device("cpu"))
