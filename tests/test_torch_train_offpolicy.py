"""The off-policy recipes against apx's examples on equal inputs: V-trace
(``train_vtrace_mesh.vtrace``) against the numpy oracle of IMPALA eq. 1
and against apx's; R2D2's value rescaling, LSTM cell, n-step double-Q
targets and ring layout against apx's; both learners' whole iterations,
with the draws apx made from its keys injected, against apx's jitted
iterations; and their one-process invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import apx
import apx_torch
from examples.train_ppo_lidar import init_net as j_init_net
from examples.train_r2d2_mesh import (init_r2d2_net as j_init_r2d2_net, lstm_step as j_lstm_step,
                                      value_rescale as j_value_rescale,
                                      value_rescale_inv as j_value_rescale_inv)
from examples.train_r2d2_mesh import make_train_iter as j_r2d2_train_iter
from examples.train_vtrace_mesh import make_train_iter as j_vtrace_train_iter
from examples.train_vtrace_mesh import vtrace as j_vtrace
from test_torch_train_ppo import _reset_draws, iteration_draws

from apx_torch.convert import ppo_net_from_numpy, r2d2_net_from_numpy
from apx_torch.distrib.mesh import EnvSharding
from apx_torch.examples.train_ppo_lidar import ClipAdam, init_net
from apx_torch.examples.train_r2d2_mesh import (ACTION_CODEBOOK, N_ACTIONS, RING_ENV_AXIS,
                                                init_r2d2_net, lstm_step, nstep_targets,
                                                ring_block, value_rescale, value_rescale_inv)
from apx_torch.examples.train_r2d2_mesh import make_train_iter as r2d2_train_iter
from apx_torch.examples.train_vtrace_mesh import clone_net, vtrace
from apx_torch.examples.train_vtrace_mesh import make_train_iter as vtrace_train_iter

torch.set_num_threads(1)


def _vtrace_inputs(seed=0, t=7, n=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, n)).astype(np.float32), rng.normal(size=(t, n)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32),
            rng.normal(scale=0.3, size=(t, n)).astype(np.float32), rng.random((t, n)) < 0.2)


def test_vtrace_matches_numpy_recursion_and_apx():
    """IMPALA eq. 1 as a direct numpy loop (apx's
    ``test_vtrace_matches_reference_recursion``), and apx's ``vtrace``."""
    r, v, v_last, log_rho, done = _vtrace_inputs()
    gamma = 0.9
    vs, pg_adv = vtrace(*(torch.from_numpy(x) for x in (r, v, v_last, log_rho, done)), gamma)

    rho = np.minimum(np.exp(log_rho), 1.0)
    c = np.minimum(np.exp(log_rho), 1.0)
    nt = 1.0 - done.astype(np.float32)
    v_next = np.concatenate([v[1:], v_last[None]], axis=0)
    delta = rho * (r + gamma * nt * v_next - v)
    vs_ref = np.zeros_like(v)
    acc = np.zeros(v.shape[1], np.float32)
    for t in reversed(range(v.shape[0])):
        acc = delta[t] + gamma * nt[t] * c[t] * acc
        vs_ref[t] = v[t] + acc
    vs_next_ref = np.concatenate([vs_ref[1:], v_last[None]], axis=0)
    pg_ref = rho * (r + gamma * nt * vs_next_ref - v)
    np.testing.assert_allclose(vs.numpy(), vs_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pg_adv.numpy(), pg_ref, rtol=1e-6, atol=1e-6)

    jvs, jpg = j_vtrace(*(jnp.asarray(x) for x in (r, v, v_last, log_rho, done)), gamma)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pg_adv.numpy(), np.asarray(jpg), rtol=0, atol=1e-6)


def test_vtrace_targets_carry_no_gradient():
    r, v, v_last, log_rho, done = (torch.from_numpy(x) for x in _vtrace_inputs(1))
    v = v.requires_grad_()
    vs, pg_adv = vtrace(r, v, v_last, log_rho, done)
    assert not vs.requires_grad and not pg_adv.requires_grad


def test_value_rescale_roundtrip_and_matches_apx():
    x = np.concatenate([np.linspace(-50, 50, 101), [0.0, 1e-4, -1e-4]]).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(value_rescale_inv(value_rescale(t)).numpy(), x, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(value_rescale(t).numpy(), np.asarray(j_value_rescale(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(value_rescale_inv(t).numpy(),
                               np.asarray(j_value_rescale_inv(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)


def test_action_codebook_is_apx_s():
    from examples.train_r2d2_mesh import ACTION_CODEBOOK as J_CODEBOOK

    assert ACTION_CODEBOOK.shape == (N_ACTIONS, 2)
    np.testing.assert_array_equal(ACTION_CODEBOOK, np.asarray(J_CODEBOOK))


@pytest.fixture(scope="module")
def r2d2_nets():
    jnet = j_init_r2d2_net(jax.random.PRNGKey(32), (32, 32), hidden=32)
    return jnet, r2d2_net_from_numpy(jax.tree_util.tree_map(np.asarray, jnet), "cpu")


def test_init_r2d2_net_layout(r2d2_nets):
    jnet, converted = r2d2_nets
    net = init_r2d2_net(torch.Generator().manual_seed(0), (32, 32), 32, "cpu")
    ours, theirs = net.state_dict(), converted.state_dict()
    assert ours.keys() == theirs.keys()
    assert not any(k.startswith(("policy", "value")) for k in ours)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
    assert float(net.lstm.wx.std()) == pytest.approx(1 / np.sqrt(256 + 32), rel=0.1)
    assert float(net.q.weight.std()) == pytest.approx(0.01, rel=0.3)


def test_lstm_step_matches_apx(r2d2_nets):
    """apx's cell as written (gates i, f, g, o; forget gate sigmoid(f + 1))."""
    jnet, net = r2d2_nets
    rng = np.random.default_rng(2)
    h, c, z = (rng.normal(size=s).astype(np.float32) for s in ((8, 32), (8, 32), (8, 256)))
    (jh, jc), jout = j_lstm_step(jnet, (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(z))
    (th, tc), out = lstm_step(net, (torch.from_numpy(h), torch.from_numpy(c)),
                              torch.from_numpy(z))
    for a, b, what in ((jh, th, "h"), (jc, tc, "c"), (jout, out, "out")):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0, atol=1e-6,
                                   err_msg=what)


def _j_targets(qs, qs_t, rew, done, gamma=0.99, nstep=3):
    """apx's ``target_at`` over every position (its ``td_loss``)."""
    lp = qs.shape[0]
    a_star = jnp.argmax(qs, axis=-1)
    q_boot = j_value_rescale_inv(jnp.take_along_axis(qs_t, a_star[..., None], axis=-1)[..., 0])

    def target_at(t):
        g = jnp.zeros_like(rew[0])
        alive = jnp.ones_like(rew[0])
        for k in range(nstep):
            tk = jnp.minimum(t + k, lp - 1)
            valid = jnp.float32(t + k < lp)
            g = g + alive * valid * (gamma ** k) * rew[tk]
            alive = alive * (1.0 - done[tk]) * valid
        tb = jnp.minimum(t + nstep, lp - 1)
        bootstrap = jnp.where(t + nstep < lp, q_boot[tb], q_boot[lp - 1])
        g = g + alive * (gamma ** nstep) * bootstrap
        return j_value_rescale(g)

    return jnp.stack([target_at(t) for t in range(lp)])


def test_nstep_double_q_targets_match_apx():
    rng = np.random.default_rng(3)
    lp, b, n = 6, 2, 4
    qs = rng.normal(size=(lp, b, n, N_ACTIONS)).astype(np.float32)
    qs_t = rng.normal(size=(lp, b, n, N_ACTIONS)).astype(np.float32)
    rew = rng.normal(size=(lp, b, n)).astype(np.float32)
    done = (rng.random((lp, b, n)) < 0.3).astype(np.float32)
    ours = nstep_targets(*(torch.from_numpy(x) for x in (qs, qs_t, rew, done)))
    ref = _j_targets(*(jnp.asarray(x) for x in (qs, qs_t, rew, done)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def _lidar(n):
    venv, params = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    g = torch.Generator().manual_seed(5)
    obs, state, _ = venv.reset(params, g)
    return venv, params, obs, state, g


def test_ring_env_axis_by_name():
    """``hidden == num_envs``: the ring's env axis found by name, never by
    shape (apx's ``RING_ENV_AXIS``)."""
    n = 8
    venv, params, obs, *_ = _lidar(n)
    _, empty_ring = r2d2_train_iter(venv, ClipAdam(), n, seq_len=6, burn_in=2, capacity=4,
                                    hidden=n)
    ring = empty_ring(obs)
    assert ring["obs"]["map"].shape == (4, 6, n, 32, 32, 1)
    assert ring["h0"].shape == (4, n, n)
    half = ring_block(ring, EnvSharding(1, 2, torch.device("cpu")))
    for k, ax in RING_ENV_AXIS.items():
        leaf = half[k]["lidar"] if k == "obs" else half[k]
        whole = ring[k]["lidar"] if k == "obs" else ring[k]
        assert leaf.shape[ax] == n // 2 and leaf.shape[:ax] == whole.shape[:ax], k
    assert half["h0"].shape == (4, n // 2, n)  # hidden axis left whole
    assert half["ptr"] is ring["ptr"]


def test_vtrace_one_process_iterations():
    """Two one-process iterations with ``sync_every=2``: finite rewards,
    the learner moved, and the behavior net synced to it bitwise."""
    n, t = 8, 4
    venv, params, obs, state, g = _lidar(n)
    net = init_net(g, params.map_bank.map_hw, "cpu")
    beh = clone_net(net)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    opt = ClipAdam()
    opt_state = opt.init(net)
    train_iter = vtrace_train_iter(venv, opt, n, t, sync_every=2)
    it = 0
    for i in range(2):
        state, obs, it, mean_r = train_iter(net, beh, opt_state, state, obs, it, g, params)
        assert np.isfinite(float(mean_r))
        synced = all(torch.equal(a, b) for a, b in zip(net.parameters(), beh.parameters()))
        assert synced == (i == 1)
    assert it == 2
    assert all((v - start[k]).abs().max() > 0 for k, v in net.state_dict().items())


def test_r2d2_one_process_iterations():
    n, hidden = 8, 32
    venv, params, obs, state, g = _lidar(n)
    net = init_r2d2_net(g, params.map_bank.map_hw, hidden, "cpu")
    target = clone_net(net)
    opt = ClipAdam(1.0, 1e-3)
    opt_state = opt.init(net)
    train_iter, empty_ring = r2d2_train_iter(venv, opt, n, seq_len=6, burn_in=2, capacity=4,
                                             batch_seqs=2, target_sync_every=2, hidden=hidden)
    ring = empty_ring(obs)
    carry = (torch.zeros(n, hidden), torch.zeros(n, hidden))
    start = {k: v.clone() for k, v in net.state_dict().items()}
    it = 0
    for _ in range(3):
        ring, state, obs, carry, it, mean_r = train_iter(net, target, opt_state, ring, state,
                                                         obs, carry, it, g, params)
        assert np.isfinite(float(mean_r))
    assert int(ring["ptr"]) == 3 and int(ring["filled"]) == 3
    # The third segment sits at index 2, its stored initial state the carry
    # the second segment ended on (nonzero: the LSTM ran).
    assert ring["h0"][2].abs().max() > 0 and not ring["h0"][3].any()
    assert not all(torch.equal(a, b) for a, b in zip(net.parameters(), target.parameters()))
    moved = [k for k, v in net.state_dict().items() if (v - start[k]).abs().max() > 0]
    assert {"lstm.wx", "q.weight", "pred.weight", "trunk.weight", "conv1.weight"} <= set(moved)


def _nets_close(jnet, net, convert, atol, what):
    """Every weight of the port's ``net`` within ``atol`` of apx's ``jnet``."""
    ref = convert(jax.tree_util.tree_map(np.asarray, jnet), "cpu").state_dict()
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


ITER_KEYS = (10, 11)  # the keys of the two iterations compared


@pytest.fixture(scope="module")
def vtrace_iterations():
    """Two V-trace iterations (``sync_every=2``: the second collects with
    the lagged behavior net, so the importance weights are not 1) of apx
    (jitted) and of the port with apx's draws: per step ``ka, ks =
    split(k)`` of ``split(key, T)``, the noise ``normal(ka, (N, 2))`` and
    the reset draws of the vector step's ``ks``, as in the PPO iteration."""
    n, t = 16, 4
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=n)
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    jnet = j_init_net(jax.random.PRNGKey(6), jp.map_bank.map_hw)
    key = jax.random.PRNGKey(2)
    jobs, jstate, _ = jax.jit(jvenv.reset)(key, jp)
    jopt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    jiter = jax.jit(j_vtrace_train_iter(jvenv, jopt, n, t, sync_every=2))
    jcarry = (jnet, jnet, jopt.init(jnet), jstate, jobs, jnp.int32(0))
    jr = []
    for k in ITER_KEYS:
        *jcarry, r = jiter(*jcarry, jax.random.PRNGKey(k), jp)
        jr.append(float(r))

    obs, state, _ = venv.reset(p, draws=_reset_draws(jp)(jax.random.split(key, n)))
    net = ppo_net_from_numpy(jax.tree_util.tree_map(np.asarray, jnet), "cpu")
    beh = clone_net(net)
    opt = ClipAdam(0.5, 3e-4)
    opt_state = opt.init(net)
    train_iter = vtrace_train_iter(venv, opt, n, t, sync_every=2)
    it, rs = 0, []
    for k in ITER_KEYS:
        draws = iteration_draws(jax.random.PRNGKey(k), jp, n, t)
        state, obs, it, r = train_iter(net, beh, opt_state, state, obs, it, None, p, draws=draws)
        rs.append(float(r))
    return jcarry, jr, net, beh, rs, it


def test_vtrace_whole_iterations_match_apx(vtrace_iterations):
    """The mean rewards within rtol 1e-5 and the learner and behavior nets
    after both iterations within 2e-5 (apx's mesh bound, as for PPO)."""
    (jnet, jbeh, *_), jr, net, beh, rs, it = vtrace_iterations
    np.testing.assert_allclose(rs, jr, rtol=1e-5)
    _nets_close(jnet, net, ppo_net_from_numpy, 2e-5, "learner after two iterations")
    _nets_close(jbeh, beh, ppo_net_from_numpy, 2e-5, "behavior after two iterations")
    assert it == 2


def _r2d2_draws(key, params, n, seq_len, batch_seqs, filled):
    """What apx's R2D2 ``train_iter(key)`` draws: ``kc, ks = split(key)``;
    per step ``ka, kexp, kstep = split(k, 3)`` of ``split(kc, seq_len)``,
    the random ids ``randint(ka, (N,), 0, 9)``, the uniforms
    ``uniform(kexp, (N,))`` and the reset draws of the vector step's
    ``kstep``; the sampled rows ``randint(ks, (B,), 0, filled)``."""
    reset = _reset_draws(params)
    kc, ks = jax.random.split(key)
    rand, explore, resets = [], [], []
    for k in jax.random.split(kc, seq_len):
        ka, kexp, kstep = jax.random.split(k, 3)
        rand.append(np.asarray(jax.random.randint(ka, (n,), 0, N_ACTIONS)))
        explore.append(np.asarray(jax.random.uniform(kexp, (n,))))
        resets.append(reset(jax.random.split(jax.random.split(kstep)[1], n)))
    idx = np.asarray(jax.random.randint(ks, (batch_seqs,), 0, max(filled, 1)))
    return {"rand": torch.from_numpy(np.stack(rand).astype(np.int64)),
            "explore": torch.from_numpy(np.stack(explore)), "reset": resets,
            "idx": torch.from_numpy(idx.astype(np.int64))}


@pytest.fixture(scope="module")
def r2d2_iterations(r2d2_nets):
    """Two R2D2 iterations (hidden 32, seq_len 8, burn-in 2, capacity 4, 2
    sequences, target sync every 2) of apx (jitted) and of the port with
    apx's draws: the second samples from a ring of two segments and
    collects from the carry the first ended on. Of the 6 positions after
    the burn-in the loss keeps 3 (n = 3), so its divisor is not 1."""
    jnet, _ = r2d2_nets
    n, hidden, seq_len, batch_seqs = 8, 32, 8, 2
    kw = dict(seq_len=seq_len, burn_in=2, capacity=4, batch_seqs=batch_seqs,
              target_sync_every=2, hidden=hidden)
    jvenv, jp = apx.make_vec("LIDARLocRooms-v0", num_envs=n)
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device="cpu")
    key = jax.random.PRNGKey(4)
    jobs, jstate, _ = jax.jit(jvenv.reset)(key, jp)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    jiter, j_empty_ring = j_r2d2_train_iter(jvenv, jopt, n, **kw)
    jiter = jax.jit(jiter)
    zeros = jnp.zeros((n, hidden))
    jcarry = (jnet, jnet, jopt.init(jnet), j_empty_ring(jobs), jstate, jobs, (zeros, zeros),
              jnp.int32(0))
    jr = []
    for k in ITER_KEYS:
        *jcarry, r = jiter(*jcarry, jax.random.PRNGKey(k), jp)
        jr.append(float(r))

    obs, state, _ = venv.reset(p, draws=_reset_draws(jp)(jax.random.split(key, n)))
    net = r2d2_net_from_numpy(jax.tree_util.tree_map(np.asarray, jnet), "cpu")
    target = clone_net(net)
    opt = ClipAdam(1.0, 1e-3)
    opt_state = opt.init(net)
    train_iter, empty_ring = r2d2_train_iter(venv, opt, n, **kw)
    ring = empty_ring(obs)
    carry = (torch.zeros(n, hidden), torch.zeros(n, hidden))
    it, rs = 0, []
    for i, k in enumerate(ITER_KEYS):
        draws = _r2d2_draws(jax.random.PRNGKey(k), jp, n, seq_len, batch_seqs, filled=i + 1)
        ring, state, obs, carry, it, r = train_iter(net, target, opt_state, ring, state, obs,
                                                    carry, it, None, p, draws=draws)
        rs.append(float(r))
    return jcarry, jr, net, target, ring, carry, rs


def test_r2d2_whole_iterations_match_apx(r2d2_iterations):
    """The mean rewards within rtol 1e-5; the ring's action ids (eps-greedy
    on the online Q) and dones equal, its rewards and stored initial states
    within 1e-5; the online and target nets after both iterations within
    2e-5, as the PPO iteration is held, and so the carry the second
    segment (collected by the once-updated net) ends on."""
    jcarry, jr, net, target, ring, carry, rs = r2d2_iterations
    jnet, jtarget, _, jring, _, _, jc, _ = jcarry
    np.testing.assert_allclose(rs, jr, rtol=1e-5)
    assert int(ring["ptr"]) == int(jring["ptr"]) == 2
    assert int(ring["filled"]) == int(jring["filled"]) == 2
    np.testing.assert_array_equal(ring["act"].numpy(), np.asarray(jring["act"]))
    np.testing.assert_array_equal(ring["done"].numpy(), np.asarray(jring["done"]))
    for k in ("rew", "h0", "c0"):
        np.testing.assert_allclose(ring[k].numpy(), np.asarray(jring[k]), rtol=0, atol=1e-5,
                                   err_msg=f"ring {k}")
    for ours, theirs in zip(carry, jc):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=2e-5)
    _nets_close(jnet, net, r2d2_net_from_numpy, 2e-5, "online after two iterations")
    _nets_close(jtarget, target, r2d2_net_from_numpy, 2e-5, "target after two iterations")
