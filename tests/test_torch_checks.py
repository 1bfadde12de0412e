"""apx_torch.core.checks: NaN actions and predictions raise apx's message;
finite ones step unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apx.core.checks import checked_step as apx_checked_step
from apx.envs.light_dark import LightDarkEnv as ApxLightDark

import apx_torch
from apx_torch.core.checks import check_finite_action, checked_step
from apx_torch.distrib.selftest import state_digest

torch.set_num_threads(1)

_BAD = {"action": ("action",), "prediction": ("prediction",), "both": ("action", "prediction")}


def _apx_message(nan_in) -> str:
    env = ApxLightDark()
    params = env.default_params()
    key = jax.random.PRNGKey(0)
    _, state, _ = env.reset(key, params)
    act = {k: jnp.array([jnp.nan, 0.0]) if k in nan_in else jnp.zeros(2)
           for k in ("action", "prediction")}
    with pytest.raises(Exception) as err:
        apx_checked_step(env.step)(key, state, act, params)
    return str(err.value)


@pytest.mark.parametrize("case", sorted(_BAD))
def test_nan_raises_apx_message(case):
    venv, params = apx_torch.make_vec("LightDark-v0", 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    _, state, _ = venv.reset(params, g)
    act = {k: torch.zeros(4, 2) for k in ("action", "prediction")}
    for k in _BAD[case]:
        act[k][2, 1] = float("nan")
    with pytest.raises(ValueError) as err:
        checked_step(venv.step)(state, act, params, g)
    ours = str(err.value)
    name = _BAD[case][0]  # apx checks the action first
    assert ours == f"NaN values detected in {name}."
    assert _apx_message(_BAD[case]).startswith(ours)


def test_finite_input_steps_unchanged():
    venv, params = apx_torch.make_vec("LightDark-v0", 8, device="cpu")
    outs = []
    for wrap in (lambda f: f, checked_step):
        g = torch.Generator().manual_seed(5)
        _, state, _ = venv.reset(params, g)
        step = wrap(venv.step)
        for _ in range(4):
            act = {"action": torch.rand((8, 2), generator=g) * 2 - 1,
                   "prediction": torch.randn((8, 2), generator=g)}
            out = step(state, act, params, g)
            state = out[1]
        outs.append(state_digest(out))
    assert outs[0] == outs[1]


def test_nested_and_integer_leaves():
    check_finite_action({"action": {"move": torch.zeros(3), "index": torch.arange(3)},
                         "prediction": (torch.ones(3, 2),)})
    check_finite_action({"action": torch.zeros(2)})  # no prediction
    check_finite_action({})
    with pytest.raises(ValueError, match="in prediction"):
        check_finite_action({"action": {"i": torch.arange(2)},
                             "prediction": (torch.zeros(1), torch.tensor([np.nan]))})
