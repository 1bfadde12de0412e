"""The port's registry against apx's: the same 158 ids, each built with
apx's autoreset mode, step limit, wrappers and metrics, and each making,
resetting, sampling an action from its space and stepping on the CPU.

The image corpora are apx's synthetic banks (no download); the test cuts
them to 64 images through the registry's own loader, so each is built
once, and restores the bank cache after."""

import pytest
import torch

from apx.registry import env_ids as apx_env_ids
from apx.registry import registry as apx_registry

import apx_torch
from apx_torch import registry
from apx_torch.data import huggingface as hf
from apx_torch.envs.circle_square_hide_and_seek import CircleSquareHideAndSeek
from apx_torch.wrappers.metrics import ClassificationMetrics, RegressionMetrics
from apx_torch.wrappers.sparsify import Sparsify
from apx_torch.wrappers.vector_to_single import VectorToSingle

torch.set_num_threads(1)
APX = apx_registry()


def test_env_ids_are_apx_ids():
    assert apx_torch.env_ids() == apx_env_ids()
    assert len(apx_torch.env_ids()) == 158
    assert sum(i.endswith("-sparse-v0") for i in apx_torch.env_ids()) == 79


def test_unknown_id_raises():
    for env_id in ("MNIST-v1", "CircleSquare", "TinyImageNetLoc-valid-v0"):
        with pytest.raises(KeyError, match="Unknown env id"):
            apx_torch.make_vec(env_id, 2, device="cpu")
        with pytest.raises(KeyError, match="Unknown env id"):
            apx_torch.make(env_id, device="cpu")


@pytest.fixture(scope="module")
def small_banks():
    """The registry's loader with 64-image banks; the cache is restored."""
    saved = dict(registry._BANK_CACHE)
    registry._BANK_CACHE.clear()
    load = hf.load_hf_image_bank
    mp = pytest.MonkeyPatch()
    mp.setattr(hf, "load_hf_image_bank", lambda *a, **k: load(*a, **{**k, "num_points": 64}))
    yield
    mp.undo()
    registry._BANK_CACHE.clear()
    registry._BANK_CACHE.update(saved)


@pytest.mark.parametrize("env_id", apx_env_ids())
def test_every_id_makes_resets_and_steps(small_banks, env_id):
    entry, ref = registry._REGISTRY[env_id], APX[env_id]
    assert entry.autoreset.value == ref.autoreset.value
    assert entry.step_limit == ref.step_limit and entry.sparse == ref.sparse
    assert entry.metrics == ref.metrics
    assert (entry.vector_wrapper is None) == (ref.vector_wrapper is None)
    n = 2
    venv, p = apx_torch.make_vec(env_id, n, device="cpu", metrics=True)
    want = {"classification": ClassificationMetrics, "regression": RegressionMetrics,
            None: None}[ref.metrics]
    if want is None:
        assert not isinstance(venv, (ClassificationMetrics, RegressionMetrics))
    else:
        assert type(venv) is want  # metrics=True wraps exactly the ids apx wraps
    assert isinstance(venv.env, Sparsify) == entry.sparse
    hide = venv.venv if want is not None else venv
    assert isinstance(hide, CircleSquareHideAndSeek) == (ref.vector_wrapper is not None)
    g = torch.Generator().manual_seed(0)
    obs, s, _ = venv.reset(p, g)
    space = venv.env.action_space(p)
    if isinstance(hide, CircleSquareHideAndSeek) and hide.mask_prediction:
        act = {"action": space.inner_action_space.sample(g, (n,)), "prediction": ()}
    else:
        act = space.sample(g, (n,))
    obs, s, r, te, tr, info = venv.step(s, act, p, g)
    assert r.shape == (n,) and torch.isfinite(r).all()
    assert all(torch.isfinite(v).all() for v in obs.values())
    if "-v0" in env_id and ("MNIST" in env_id or "CIFAR" in env_id or "TinyImageNet" in env_id):
        assert p.dataset.bank_kind in ("synthetic", "huggingface")
        split = "train" if "-test" not in env_id else ("valid" if "TinyImageNet" in env_id
                                                       else "test")
        key = [k for k, v in registry._BANK_CACHE.items() if v is p.dataset][0]
        assert key[2] == split and key[-1] == "cpu"


def test_make_of_a_vector_wrapped_id(small_banks):
    single, p = apx_torch.make("CircleSquareHideAndSeek-sparse-v0", device="cpu")
    assert isinstance(single, VectorToSingle) and single.vec.num_envs == 1
    env, p = apx_torch.make("TinyImageNetLoc-test-v0", device="cpu")
    assert p.sensor_size == (10, 10) and p.render_unvisited_opacity == 0.5
    assert p.dataset.image_shape == (64, 64, 3)
