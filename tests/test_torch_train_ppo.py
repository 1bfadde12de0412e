"""The PPO recipe (``apx_torch.examples.train_ppo_lidar``) against apx's
``examples/train_ppo_lidar.py`` on the same inputs: the forward pieces,
GAE and the PPO loss with its gradient, the optimizer, the prediction
gradient through the env, and one whole iteration with the draws apx
made from its keys injected. Weights cross with ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import apx
from examples.train_ppo_lidar import (apply_dense as j_apply_dense, encode as j_encode,
                                      init_net as j_init_net, logp_gauss as j_logp_gauss,
                                      make_train_iter as j_make_train_iter,
                                      policy_dist as j_policy_dist)

import apx_torch
from apx_torch.convert import ppo_net_from_numpy
from apx_torch.examples.train_ppo_lidar import (ClipAdam, encode, gae, init_net, logp_gauss,
                                                make_train_iter, policy_dist, ppo_loss,
                                                resume_check)

torch.set_num_threads(1)
N, T, MINIBATCHES, EPOCHS = 16, 4, 2, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _random_obs(rng, n):
    return {"lidar": rng.uniform(0, 1, (n, 8)).astype(np.float32),
            "odometry": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            "time_step": rng.uniform(-1, 1, (n,)).astype(np.float32),
            "map": (rng.random((n, 32, 32, 1)) < 0.3).astype(np.float32) / 255.0}


def _reset_draws(params):
    """keys -> the (bank_pos, k) draws apx's LIDAR reset makes from each key
    (tests/test_torch_lidar_env.py's ``_draw_fn``)."""
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


def iteration_draws(key, params, n=N, t=T, epochs=EPOCHS, minibatches=MINIBATCHES):
    """What apx's ``train_iter(key)`` draws, for the port's ``draws``: per
    step ``ka, ks = split(k)`` of ``split(key, T)``, the noise
    ``normal(ka, (N, 2))`` and the reset draws of ``split(split(ks)[1], N)``
    (apx's vector step splits (step key, reset key)); the permutations of
    ``fold_in(fold_in(key, 1), e)``."""
    reset = _reset_draws(params)
    noise, resets = [], []
    for k in jax.random.split(key, t):
        ka, ks = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(ka, (n, 2))))
        resets.append(reset(jax.random.split(jax.random.split(ks)[1], n)))
    rows = t * n
    perm_key = jax.random.fold_in(key, 1)
    perm = np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(perm_key, e), rows))
                     .reshape(minibatches, rows // minibatches) for e in range(epochs)])
    return {"noise": torch.from_numpy(np.stack(noise)), "reset": resets,
            "perm": torch.from_numpy(perm.reshape(epochs * minibatches, -1).astype(np.int64))}


@pytest.fixture(scope="module")
def setup():
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=N)
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", N, device="cpu")
    jnet = j_init_net(jax.random.PRNGKey(4), jp.map_bank.map_hw)
    return jvenv, jp, venv, p, jnet


def _close(a, b, atol, what, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=rtol, atol=atol,
                               err_msg=what)


def _net_close(jnet, net, atol, what):
    """Every leaf of apx's net within ``atol`` of the port's."""
    state = net.state_dict()
    for name, leaves in jnet.items():
        w = np.asarray(leaves["w"])
        _close(w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T, state[f"{name}.weight"], atol,
               f"{what} {name}.w")
        _close(leaves["b"], state[f"{name}.bias"], atol, f"{what} {name}.b")


def test_init_net_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    net = init_net(g, (32, 32), "cpu")
    jnet = j_init_net(jax.random.PRNGKey(0), (32, 32))
    state = net.state_dict()
    for name, leaves in jnet.items():
        w = state[f"{name}.weight"]
        assert w.shape == ppo_net_from_numpy(_np_tree(jnet), "cpu").state_dict()[
            f"{name}.weight"].shape
        fan_in = int(np.prod(np.asarray(leaves["w"]).shape[:-1]))
        assert abs(float(w.std()) / np.sqrt(2.0 / fan_in) - 1) < 0.25, name
        assert not state[f"{name}.bias"].any()


def test_forward_pieces_match_apx(setup):
    """Each piece on equal inputs. ``encode`` within 2e-6: its products sum
    2048 (``map_proj``) and 256 (``trunk``) float32 terms, in another order
    than XLA's dot (measured up to 1.34e-6 over four seeds); the heads,
    fed apx's ``z``, within 1e-6 (the log-probability, down to -75, also
    within 1e-6 relative: one ulp)."""
    *_, jnet = setup
    net = ppo_net_from_numpy(_np_tree(jnet), "cpu")
    obs = _random_obs(np.random.default_rng(0), N)
    jz = j_encode(jnet, {k: jnp.asarray(v) for k, v in obs.items()})
    _close(jz, encode(net, _to_torch(obs)), 2e-6, "encode")
    z = torch.from_numpy(np.array(jz))
    jmean, jlogstd = j_policy_dist(jnet, jz)
    mean, logstd = policy_dist(net, z)
    _close(jmean, mean, 1e-6, "mean")
    _close(jlogstd, logstd, 1e-6, "logstd")
    a = np.random.default_rng(1).normal(size=(N, 2)).astype(np.float32)
    _close(j_logp_gauss(jnp.asarray(a), jmean, jlogstd),
           logp_gauss(torch.from_numpy(a), torch.from_numpy(np.array(jmean)),
                      torch.from_numpy(np.array(jlogstd))), 1e-6, "logp", rtol=1e-6)
    _close(j_apply_dense(jnet["pred"], jz, jnp.tanh), torch.tanh(net.pred(z)), 1e-6, "pred")


def test_conv_padding_is_jax_same_at_stride_two(setup):
    """JAX's SAME at stride 2 pads (0, 1); ``F.conv2d(padding=1)``'s (1, 1)
    would compute another function (a guard that the test can tell)."""
    *_, jnet = setup
    net = ppo_net_from_numpy(_np_tree(jnet), "cpu")
    x = torch.from_numpy(np.random.default_rng(2).random((2, 1, 32, 32)).astype(np.float32))
    w = net.conv1.weight
    ours = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (0, 1, 0, 1)), w, stride=2)
    jx = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    ref = jax.lax.conv_general_dilated(jx, jnet["conv1"]["w"], (2, 2), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _close(np.asarray(ref).transpose(0, 3, 1, 2), ours, 1e-6, "conv1")
    sym = torch.nn.functional.conv2d(x, w, stride=2, padding=1)
    assert (sym - ours).abs().max() > 1e-3


def _j_gae(r, v, done, v_last, gamma=0.99, lam=0.95):
    """apx's ``gae_step`` scan, as its train_iter runs it."""
    def gae_step(carry, x):
        adv_next, v_next = carry
        r, v, done = x
        nonterm = 1.0 - done.astype(jnp.float32)
        delta = r + gamma * v_next * nonterm - v
        adv = delta + gamma * lam * nonterm * adv_next
        return (adv, v), adv

    _, adv = jax.lax.scan(gae_step, (jnp.zeros_like(v_last), v_last), (r, v, done), reverse=True)
    return adv, adv + v


def _j_ppo_loss(net, mb_data, clip_eps=0.2, vf_coef=0.5, ent_coef=1e-3):
    """apx's ``ppo_loss``, as its train_iter defines it."""
    o, a_raw, logp_old, adv, ret, v_old = mb_data
    z = j_encode(net, o)
    mean, logstd = j_policy_dist(net, z)
    logp = j_logp_gauss(a_raw, mean, logstd)
    ratio = jnp.exp(logp - logp_old)
    pg = -jnp.minimum(ratio * adv, jnp.clip(ratio, 1 - clip_eps, 1 + clip_eps) * adv).mean()
    v = j_apply_dense(net["value"], z)[..., 0]
    v_clip = v_old + jnp.clip(v - v_old, -clip_eps, clip_eps)
    vloss = 0.5 * jnp.maximum(jnp.square(v - ret), jnp.square(v_clip - ret)).mean()
    ent = jnp.sum(logstd + 0.5 * jnp.log(2 * jnp.pi * jnp.e), axis=-1).mean()
    return pg + vf_coef * vloss - ent_coef * ent


def test_gae_and_ppo_loss_gradient_match_apx(setup):
    *_, jnet = setup
    rng = np.random.default_rng(3)
    r = rng.normal(size=(T, N)).astype(np.float32)
    v = rng.normal(size=(T, N)).astype(np.float32)
    v_last = rng.normal(size=(N,)).astype(np.float32)
    done = rng.random((T, N)) < 0.2
    jadv, jret = jax.jit(_j_gae)(jnp.asarray(r), jnp.asarray(v), jnp.asarray(done),
                                 jnp.asarray(v_last))
    adv, ret = gae(*(torch.from_numpy(x) for x in (r, v, done, v_last)))
    _close(jadv, adv, 2e-5, "advantages")
    _close(jret, ret, 2e-5, "returns")

    mb = 24
    obs = _random_obs(rng, mb)
    a_raw = rng.normal(size=(mb, 2)).astype(np.float32)
    net = ppo_net_from_numpy(_np_tree(jnet), "cpu")
    with torch.no_grad():
        mean, logstd = policy_dist(net, encode(net, _to_torch(obs)))
        # Old log-probabilities near the current ones, so that both sides of
        # the clip are taken.
        logp_old = (logp_gauss(torch.from_numpy(a_raw), mean, logstd)
                    + torch.from_numpy(rng.normal(scale=0.3, size=mb).astype(np.float32)))
    data = [obs, a_raw, logp_old.numpy(), rng.normal(size=mb).astype(np.float32),
            rng.normal(size=mb).astype(np.float32), rng.normal(size=mb).astype(np.float32)]
    jdata = [{k: jnp.asarray(x) for k, x in data[0].items()}] + [jnp.asarray(x) for x in data[1:]]
    jloss, jgrads = jax.jit(jax.value_and_grad(_j_ppo_loss))(jnet, jdata)
    loss = ppo_loss(net, [_to_torch(data[0])] + [torch.from_numpy(x) for x in data[1:]], mb)
    loss.backward()
    _close(jloss, loss, 2e-5, "ppo loss")
    # Each leaf within 2e-5 of its largest entry (at least 2e-5): the
    # gradients reach 8.5 on this minibatch, and apx's and the port's are
    # each ~1e-5 of that from the float64 gradient (conv1: 3.6e-5 and
    # 2.7e-5 of 4.3), sums of float32 terms in different orders.
    for name, leaves in jgrads.items():
        layer = getattr(net, name)
        for ref, got, leaf in ((np.asarray(leaves["w"]), layer.weight.grad, "w"),
                               (np.asarray(leaves["b"]), layer.bias.grad, "b")):
            if ref.ndim == 4:
                ref = ref.transpose(3, 2, 0, 1)
            elif ref.ndim == 2:
                ref = ref.T
            if got is None:  # no path from the loss (``pred``): apx's is zero
                assert not ref.any(), f"grad {name}.{leaf}"
                continue
            _close(ref, got, 2e-5 * max(1.0, float(np.abs(ref).max())), f"grad {name}.{leaf}")


@pytest.mark.parametrize("scale", [1e-4, 10.0], ids=["unclipped", "clipped"])
def test_optimizer_step_matches_optax_chain(setup, scale):
    """ClipAdam against ``optax.chain(clip_by_global_norm(0.5), adam(3e-4))``
    over three steps on equal gradients: below the norm (kept) and above
    it (scaled by max / norm)."""
    *_, jnet = setup
    net = ppo_net_from_numpy(_np_tree(jnet), "cpu")
    opt = ClipAdam(0.5, 3e-4)
    state = opt.init(net)
    jopt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    jstate = jopt.init(jnet)
    jn = jnet
    rng = np.random.default_rng(4)
    norms = []
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)) * scale, jn)
        norms.append(float(optax.global_norm(grads)))
        for name, leaves in grads.items():
            layer = getattr(net, name)
            w = np.asarray(leaves["w"])
            layer.weight.grad = torch.from_numpy(
                np.ascontiguousarray(w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T))
            layer.bias.grad = torch.from_numpy(np.asarray(leaves["b"]))
        opt.step(state)
        updates, jstate = jopt.update(grads, jstate, jn)
        jn = optax.apply_updates(jn, updates)
    assert all(n < 0.5 for n in norms) if scale < 1 else all(n > 0.5 for n in norms)
    _net_close(jn, net, 1e-6, "after three steps")


def _j_pred_loss(jvenv, jp, actions):
    """-r.mean() of a rollout with the given actions and the net's
    predictions: apx's ``pred_reward_fn`` with the policy's actions replaced."""
    def loss(net, obs, state, key):
        rs = []
        for t, k in enumerate(jax.random.split(key, actions.shape[0])):
            z = j_encode(net, obs)
            pred = jnp.tanh(j_apply_dense(net["pred"], z))
            _, ks = jax.random.split(k)
            obs, state, r, *_ = jvenv.step(ks, state, {"action": actions[t], "prediction": pred},
                                           jp)
            rs.append(r)
        return -jnp.stack(rs).mean()

    return jax.jit(jax.grad(loss))


def test_prediction_gradient_through_the_env(setup):
    """The gradient of ``-r.mean()`` over a 4-step rollout w.r.t. the net
    crosses the env's loss (VectorAPEnv's masked merge, TimeLimit, the
    normalized MSE's exact FMAs) as apx's does: equal on ``pred``,
    ``trunk`` and the encoder, exactly zero on ``policy`` and ``value``."""
    jvenv, jp, venv, p, jnet = setup
    key = jax.random.PRNGKey(7)
    jobs, jstate, _ = jax.jit(jvenv.reset)(key, jp)
    draws = _reset_draws(jp)
    obs, state, _ = venv.reset(p, draws=draws(jax.random.split(key, N)))
    actions = np.random.default_rng(5).uniform(-1, 1, (T, N, 2)).astype(np.float32)
    step_key = jax.random.PRNGKey(8)
    jgrads = _j_pred_loss(jvenv, jp, actions)(jnet, jobs, jstate, step_key)

    net = ppo_net_from_numpy(_np_tree(jnet), "cpu")
    rs = []
    for t, k in enumerate(jax.random.split(step_key, T)):
        pred = torch.tanh(net.pred(encode(net, obs)))
        reset = draws(jax.random.split(jax.random.split(jax.random.split(k)[1])[1], N))
        obs, state, r, *_ = venv.step(state, {"action": torch.from_numpy(actions[t]),
                                              "prediction": pred}, p, reset_draws=reset)
        rs.append(r)
    (-torch.stack(rs).mean()).backward()
    for name in ("pred", "trunk", "map_proj", "prop", "conv1", "conv2"):
        layer = getattr(net, name)
        w = np.asarray(jgrads[name]["w"])
        _close(w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T, layer.weight.grad, 2e-5,
               f"grad {name}.w")
        _close(jgrads[name]["b"], layer.bias.grad, 2e-5, f"grad {name}.b")
        assert layer.weight.grad.abs().max() > 0, name
    for name in ("policy", "value"):
        assert not np.asarray(jgrads[name]["w"]).any()
        assert getattr(net, name).weight.grad is None  # no path: exactly zero


@pytest.fixture(scope="module")
def whole_iteration(setup):
    """One PPO iteration of apx (jitted) and of the port with apx's draws."""
    jvenv, jp, venv, p, jnet = setup
    key = jax.random.PRNGKey(3)
    jobs, jstate, _ = jax.jit(jvenv.reset)(key, jp)
    jopt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    jiter = jax.jit(j_make_train_iter(jvenv, jopt, N, T, num_minibatches=MINIBATCHES))
    k_iter = jax.random.PRNGKey(9)
    jnet2, _, _, _, jr = jiter(jnet, jopt.init(jnet), jstate, jobs, k_iter, jp)

    obs, state, _ = venv.reset(p, draws=_reset_draws(jp)(jax.random.split(key, N)))
    net = ppo_net_from_numpy(_np_tree(jnet), "cpu")
    opt = ClipAdam(0.5, 3e-4)
    opt_state = opt.init(net)
    train_iter = make_train_iter(venv, opt, N, T, num_minibatches=MINIBATCHES)
    _, _, r = train_iter(net, opt_state, state, obs, None, p,
                         draws=iteration_draws(k_iter, jp))
    return jnet2, float(jr), net, float(r), opt_state


def test_whole_iteration_matches_apx(whole_iteration):
    jnet2, jr, net, r, opt_state = whole_iteration
    np.testing.assert_allclose(r, jr, rtol=1e-5)
    _net_close(jnet2, net, 2e-5, "net after one iteration")
    # One prediction step and epochs x minibatches PPO steps on one optimizer.
    steps = {float(s["step"]) for s in opt_state.state.values()}
    assert steps == {1.0 + EPOCHS * MINIBATCHES}


def test_iteration_moved_every_layer(setup, whole_iteration):
    *_, jnet = setup
    _, _, net, _, _ = whole_iteration
    start = ppo_net_from_numpy(_np_tree(jnet), "cpu").state_dict()
    for k, v in net.state_dict().items():
        assert (v - start[k]).abs().max() > 0, k


def test_trainer_resume_is_bit_identical(tmp_path):
    """Checkpoint the trainer (net, Adam moments and step, env state, obs,
    generator) after two iterations; the resumed run equals the
    uninterrupted one bitwise (after apx's
    ``test_learner_checkpoint_resume_bit_identical``). ``chip_smoke.py``
    runs the same check on the card."""
    n, t = 8, 4
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    res = resume_check(venv, p, n, t, str(tmp_path / "trainer.pt"), num_minibatches=2)
    assert res["bitwise"], res
    # 16 net leaves, 3 x 16 of Adam's, the env state's, 4 obs, the generator.
    assert res["leaves"] > 16 + 48 + 4 + 1


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_net(torch.Generator(), (32, 32))
