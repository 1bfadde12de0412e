"""TinyImageNet-sparse-v0 with its episode-metric wrapper on the CPU against
the benchmark's plain reference (``benchmark/reference/image_cls_sparse.py``,
float64, written from ap_gym's semantics and independent of the port):
three LOCKSTEP cycles (the boundary reset, then 16 steps) through the
family's ``step_chunk`` over a seeded bank of 512 images. Each step's
reward carries the loss only on the episode's 16th step, the info's loss
is the dense one (the boundary's against the new label), the metrics'
buffer, count and statistics follow the reference's; the reference
computed in bfloat16 departs; the family composes the env as
``make_vec(..., metrics=True)`` does, and refuses other constants."""

import math

import pytest
import torch

import apx_torch
from apx_torch.core.env import AutoResetMode
from apx_torch.data.dataset import BankImageDataset
from benchmark import manifest
from benchmark.families import image_cls_sparse as family
from benchmark.kinds import rollout
from benchmark.reference import image_cls_sparse as ref
from benchmark.yardstick.judge import departures

N = 32
BANK = 512
CYCLES = 3
TOL = 1e-5
CELL = "tin_cls_sparse.rollout"


def _cell():
    cell = manifest.cell(manifest.load(), CELL)
    config = {**cell["config"], "bank_images": BANK}
    traffic = {**cell["traffic"], "num_envs": N, "check_block_envs": N // 2}
    return cell, config, traffic


def _env(seed):
    _, config, traffic = _cell()
    return family.build(config, traffic, seed, torch.device("cpu"))


def _gap(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _check(leaves, want, what, sum_tol=TOL):
    for key, w in want.items():
        got = leaves[key]
        if w.is_floating_point():
            tol = sum_tol if key in ("reward_sum", "info_loss_sum") else TOL
            assert _gap(got, w) <= tol, (what, key, _gap(got, w))
        else:
            assert torch.equal(got.long(), w.long()), (what, key)


def _check_stats(got: dict, want: dict, what):
    """Every statistic and mask: the masks equal, the values where masked."""
    for name in ref.STATS:
        mask = want[f"_{name}"]
        assert torch.equal(got[f"_{name}"], mask), (what, name)
        g, w = got[name][mask], want[name][mask]
        if w.is_floating_point():
            assert _gap(g, w) <= TOL, (what, name)
        else:
            assert torch.equal(g.long(), w.long()), (what, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_cycles_follow_the_reference(seed):
    """The family's chunk gives the reference's leaves and sums; stepped
    one by one, each step's obs, state, reward, info loss, metrics buffer
    and count, and statistics are the reference's within 1e-5."""
    env = _env(seed)
    g = torch.Generator().manual_seed(100 + seed)
    policy = rollout.policy
    obs, state, lead = family.initial_reset(env, g, policy)
    _check(family.program_leaves(obs, state), family.reference_reset(env, lead, torch.float64),
           "lead", sum_tol=1e-4)
    for cycle in range(CYCLES):
        draws = family.draw_pool(env, g, env.chunk)
        racc = torch.zeros(N)
        dacc = torch.zeros(N, dtype=torch.int32)
        c_obs, c_state = family.step_chunk(env, obs, state, draws, racc, dacc, policy)
        want = family.reference_chunk(env, None, draws, None, torch.float64, policy)
        _check({**family.program_leaves(c_obs, c_state), "reward_sum": racc, "term_count": dacc},
               want, f"chunk {cycle}", sum_tol=1e-4)
        assert int(dacc.sum()) == N and bool(c_state["stats"]["_avg_accuracy"].all())
        # Step by step, as the chunk steps.
        m = state["metrics"]
        r_state = None
        for j in range(env.chunk):
            pred = draws["prediction"][j]
            full = {"action": policy(draws["action"][j], obs), "prediction": pred}
            if j == 0:
                obs, m, reward, term, trunc, info = env.venv.boundary_reset_step(
                    m, full, env.params, reset_draws=family.base._reset_draws(draws, 0),
                    step_draws={})
                r = ref.boundary_step(env.images, env.labels, pred, draws["index"][0],
                                      draws["pos"][0], torch.float64)
                target = info["prediction"]["target"]
                assert torch.equal(target["target"], env.labels[draws["index"][0]])
                assert not bool(target["weight"].any())
            else:
                obs, m, reward, term, trunc, info = env.inner.step(m, full, env.params,
                                                                   step_draws={})
                r = ref.step(env.images, env.labels, r_state, full["action"], pred)
            r_obs, r_state, r_rew, r_term, r_trunc, r_loss, r_stats = r
            assert _gap(reward, r_rew) <= TOL, (cycle, j)
            # Only the episode's last step is charged the loss.
            assert bool(((reward == info["base_reward"]) | term).all()), (cycle, j)
            assert _gap(info["prediction"]["loss"], r_loss) <= TOL, (cycle, j)
            assert torch.equal(term, r_term) and torch.equal(trunc, r_trunc)
            leaves = family.program_leaves(obs, {"metrics": m, "info_loss_sum": r_loss,
                                                 "stats": info["stats"]["scalar"]})
            valid = torch.arange(ref.BUFFER) < r_state["count"][:, None]
            assert torch.equal(leaves["count"].long(), r_state["count"]), (cycle, j)
            assert _gap(leaves["buf"][valid], r_state["buf"][valid]) <= TOL, (cycle, j)
            _check(leaves, {**r_obs, **{k: r_state[k] for k in ("data_index", "pos", "time",
                                                                 "prev_done")},
                            "metrics_prev_done": r_state["prev_done"]}, (cycle, j))
            _check_stats(info["stats"]["scalar"], r_stats, (cycle, j))
        assert torch.equal(m.buf["correct_label_prob"], c_state["metrics"].buf[
            "correct_label_prob"])
        state = {"metrics": m}


def test_the_episode_statistics_take_every_value():
    """Over a few chunks the statistics are not all alike: some episodes
    have a correct step and some not, and accuracy lies strictly between
    0 and 1 in some, so the check compares more than constants."""
    env = _env(4)
    g = torch.Generator().manual_seed(12)
    want = family.reference_chunk(env, None, family.draw_pool(env, g, env.chunk), None,
                                  torch.float64, rollout.policy)
    acc = want["stats.avg_accuracy"]
    assert bool(((acc > 0) & (acc < 1)).any())
    assert bool((want["stats.first_correct"] >= 0).any())
    assert bool(want["stats._last_incorrect"].all())


def test_bfloat16_reference_departs():
    env = _env(3)
    g = torch.Generator().manual_seed(8)
    draws = family.draw_pool(env, g, env.chunk)
    policy = rollout.policy
    want = family.reference_chunk(env, None, draws, None, torch.float64, policy)
    low = family.reference_chunk(env, None, draws, None, torch.bfloat16, policy)
    bad, report = departures(low, want, 1e-3)
    assert float(bad.float().mean()) > 0.9, report
    # The sums of order one depart; the probabilities (about 1/200) lie
    # within the absolute tolerance in bfloat16 too.
    for key in ("reward_sum", "info_loss_sum"):
        assert report[key]["departing"] > N // 2, (key, report[key])


def _composition(venv):
    """The wrapper types from the outside in, the buffer, the autoreset
    and the loss's types."""
    loss_fn = venv.env.loss_fn(venv.env.default_params())
    return (type(venv).__name__, venv.buffer_len, type(venv.venv).__name__,
            venv.venv.autoreset, type(venv.env).__name__, type(venv.env.env).__name__,
            type(loss_fn).__name__, type(loss_fn.inner).__name__,
            type(loss_fn.inner.inner).__name__)


def _hf_bank(monkeypatch, config):
    """The corpus' loader replaced by a seeded CPU bank of its geometry."""
    from apx_torch import registry

    g = torch.Generator().manual_seed(9)
    h, w, c = config["image_shape"]
    bank = BankImageDataset(torch.randint(0, 256, (BANK, h, w, c), generator=g,
                                          dtype=torch.uint8),
                            torch.randint(0, config["classes"], (BANK,), generator=g),
                            config["classes"])
    monkeypatch.setattr(registry, "_hf_bank", lambda name, split, device, **kw: bank)


@pytest.mark.parametrize("env_id", ["TinyImageNet-sparse-v0", "CircleSquare-s15-sparse-v0"])
def test_family_composes_as_make_vec(env_id, monkeypatch):
    """The family's env has ``make_vec(<id>, metrics=True)``'s wrappers, in
    its order, with its buffer length, autoreset and loss, for the
    configuration's id (over a CPU bank) and a CPU id of the same kind; for
    the configuration's id the parameters and the normalization too."""
    cell, config, traffic = _cell()
    _hf_bank(monkeypatch, config)
    venv, params = apx_torch.make_vec(env_id, N, device="cpu", metrics=True)
    built = family.build(config, traffic, 0, torch.device("cpu"))
    assert _composition(venv) == _composition(built.venv)
    assert _composition(built.venv)[:6] == (
        "ClassificationMetrics", 16, "VectorAPEnv", AutoResetMode.LOCKSTEP, "Sparsify",
        "ImageClassificationEnv")
    assert type(built.inner.venv).__name__ == "VectorAPEnv"
    assert built.inner.venv.autoreset is AutoResetMode.DISABLED
    if env_id == cell["config"]["env_id"]:
        for p in (params, built.params):
            assert list(p.sensor_size) == config["sensor_size"]
            assert p.step_limit == config["step_limit"] == config["metrics"]["buffer"]
            assert tuple(p.max_step_length) == (config["max_step_length"],) * 2
            assert p.randomly_invert_labels is False
            assert p.dataset.num_classes == config["classes"]
        for loss_fn in (venv.env.loss_fn(params), built.venv.env.loss_fn(built.params)):
            assert math.isclose(loss_fn.inner.scale, 1.0 / math.log(config["classes"]))
            assert loss_fn.inner.offset == 0.0


def test_build_refuses_other_constants(monkeypatch):
    _, config, traffic = _cell()
    for change in ({"sensor_size": [5, 5]}, {"step_limit": 32}, {"max_step_length": 0.1},
                   {"classes": 10}):
        with pytest.raises(ValueError, match="the reference"):
            family.build({**config, **change, "bank_images": 8}, traffic, 0,
                         torch.device("cpu"))
    for metrics in ({"kind": "classification", "buffer": 8},
                    {"kind": "regression", "buffer": 16}):
        with pytest.raises(ValueError, match="buffer"):
            family.build({**config, "metrics": metrics, "bank_images": 8}, traffic, 0,
                         torch.device("cpu"))
    from apx_torch.core.losses import WeightedLossFn
    from apx_torch.wrappers.sparsify import Sparsify

    # A sparse loss over another inner loss: the un-normalized cross-entropy.
    monkeypatch.setattr(Sparsify, "loss_fn", lambda self, params: WeightedLossFn(
        inner=self.env.loss_fn(params).inner))
    with pytest.raises(ValueError, match="loss"):
        family.build({**config, "bank_images": 8}, traffic, 0, torch.device("cpu"))
