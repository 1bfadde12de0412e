"""The dry run's training step (``apx_torch.graft_entry.train_step``)
against apx's check 3 (``__graft_entry__.py:174-198``) on the same inputs.

apx's check 3 differentiates its loss through the env with the action
live. On the dry run's headline env that gradient is not finite in
``w1``, ``b1`` and ``w_act``, which the last test pins. The port steps the
env with the action detached, so it is held to apx's same loss with the
env's action under ``stop_gradient``, built here from apx's pieces
(``__graft_entry__.py`` is not edited): apx's weights cross over as numpy,
and the draws apx makes from its key schedule are injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import (_flat_obs as j_flat_obs, _make_headline as j_make_headline,
                             _mlp_apply as j_mlp_apply, _mlp_init as j_mlp_init)

from apx_torch.graft_entry import LR, ROLLOUT, _make_headline, train_step

torch.set_num_threads(1)
N, HIDDEN = 8, 16  # apx's dry run on four devices: data 2 x model 2


def _reset_draws(params):
    """keys -> the (bank_pos, k) draws apx's LIDAR reset makes from each key."""
    bank = params.map_bank

    def one(key):
        k_map, k_cell = jax.random.split(key)
        bank_pos = jax.random.randint(k_map, (), 0, bank.num_maps, dtype=jnp.int32)
        return bank_pos, jax.random.randint(k_cell, (), 0, jnp.take(bank.free_counts, bank_pos),
                                            dtype=jnp.int32)

    batched = jax.jit(jax.vmap(one))

    def draws(keys):
        bank_pos, k = batched(keys)
        return {"bank_pos": torch.from_numpy(np.asarray(bank_pos).astype(np.int64)),
                "k": torch.from_numpy(np.asarray(k).astype(np.int64))}

    return draws


def _apx_loss(venv, params, state0, obs0, key, live: bool):
    """apx's check-3 loss (``__graft_entry__.py:174-198``) of the weights,
    with the env's action live (as apx writes it) or under stop_gradient."""

    def loss_of(weights):
        def body(carry, k):
            obs, state = carry
            act_mean, pred = j_mlp_apply(weights, j_flat_obs(obs))
            ka, ks = jax.random.split(k)
            act = act_mean + 0.1 * jax.random.normal(ka, act_mean.shape)
            env_act = act if live else jax.lax.stop_gradient(act)
            obs2, state2, reward, term, trunc, info = venv.step(
                ks, state, {"action": env_act, "prediction": pred}, params)
            logp = -jnp.sum(jnp.square(act - act_mean), axis=-1)
            target = info["prediction"]["target"]
            if isinstance(target, dict):
                target = target["target"]
            pred_err = jnp.sum(jnp.square(pred - target), axis=-1)
            return (obs2, state2), jnp.mean(pred_err + jax.lax.stop_gradient(-reward) * logp)

        _, losses = jax.lax.scan(body, (obs0, state0), jax.random.split(key, ROLLOUT))
        return losses.mean()

    return jax.jit(jax.value_and_grad(loss_of))


@pytest.fixture(scope="module")
def setup():
    """apx's key schedule (``__graft_entry__.py:160-167``), its reset,
    weights and step key, and the port's draws from the same keys."""
    jvenv, jp = j_make_headline(N)
    k_reset, k_w, k_step = jax.random.split(jax.random.key(0), 3)
    obs0, state0, _ = jax.jit(jvenv.reset)(k_reset, jp)
    weights = j_mlp_init(k_w, j_flat_obs(obs0).shape[-1], HIDDEN, d_act=2, d_pred=2)
    reset = _reset_draws(jp)
    draws = {"reset": reset(jax.random.split(k_reset, N)), "noise": [], "step": [],
             "merge_reset": []}
    for k in jax.random.split(k_step, ROLLOUT):
        ka, ks = jax.random.split(k)
        draws["noise"].append(torch.from_numpy(np.array(jax.random.normal(ka, (N, 2)))))
        draws["step"].append({})
        # apx's vector step splits (step key, reset key); the merge's resets
        # draw from split(reset key, N).
        draws["merge_reset"].append(reset(jax.random.split(jax.random.split(ks)[1], N)))
    return jvenv, jp, state0, obs0, k_step, weights, draws


def test_train_step_equals_apx_stop_gradient_step(setup):
    jvenv, jp, state0, obs0, k_step, weights, draws = setup
    loss, grads = _apx_loss(jvenv, jp, state0, obs0, k_step, live=False)(weights)
    venv, params = _make_headline(N, "cpu")
    got_loss, step = train_step(venv, params,
                                {k: torch.from_numpy(np.array(v)) for k, v in weights.items()},
                                draws)
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
    want = {k: -LR * np.asarray(g) for k, g in grads.items()}
    assert all(np.isfinite(v).all() for v in want.values())
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        err = np.abs(step[k].numpy() - v).max()
        assert err <= 2e-5 * scale, f"{k}: |step - apx's| {err} > 2e-5 x {scale}"


def test_apx_live_action_gradient_is_not_finite(setup):
    """The reason the port follows the stop-gradient form: apx's check 3 as
    written gives a gradient with no finite entry in w1, b1 and w_act,
    while w_pred's (which does not reach the action) equals the
    stop-gradient form's."""
    jvenv, jp, state0, obs0, k_step, weights, _ = setup
    loss, live = _apx_loss(jvenv, jp, state0, obs0, k_step, live=True)(weights)
    _, detached = _apx_loss(jvenv, jp, state0, obs0, k_step, live=False)(weights)
    assert np.isfinite(float(loss))
    for k in ("w1", "b1", "w_act"):
        assert not np.isfinite(np.asarray(live[k])).any(), k
    np.testing.assert_array_equal(np.asarray(live["w_pred"]), np.asarray(detached["w_pred"]))
