"""Shared helpers of the compat parity tests: one seeded run of
``apx.compat`` and ``apx_torch.compat`` (on the CPU) side by side, every
output compared leaf by leaf, dtypes included."""

import numpy as np

import apx.compat as jc
import apx_torch.compat as tc

# Image ids: the glimpses come from different bilinear forms (XLA's and
# the port's plain form), one or two ulps apart; the losses are composed on
# the host from the same targets.
GLIMPSE_TOL = 2e-5
REWARD_TOL = 1e-6
IMAGE_TOL = {"glimpse": GLIMPSE_TOL, "target_glimpse": GLIMPSE_TOL, "reward": REWARD_TOL,
             "loss": REWARD_TOL, "base_reward": REWARD_TOL}
STATS_TOL = REWARD_TOL


def same_tree(a, b, path: str, tol: dict | None = None, err: dict | None = None) -> None:
    """a (apx) and b (port) equal: keys, dtypes, shapes, values. Floats are
    bitwise (NaNs in the same places) unless the leaf's name is in ``tol``;
    a stats float (under ``stats``) is held to STATS_TOL when ``tol`` is
    given. Object arrays (vector stats series) compare element by element;
    tuples and Python scalars (single-env outputs) by type and value."""
    tol = tol or {}
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), b)
        for k in a:
            same_tree(a[k], b[k], f"{path}/{k}", tol, err)
        return
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{path}[{i}]", tol, err)
        return
    if not isinstance(a, np.ndarray):
        assert type(a) is type(b), (path, type(a), type(b))
        a, b = np.asarray(a), np.asarray(b)
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype == object:
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(np.asarray(x), np.asarray(y), f"{path}[{i}]", tol, err)
        return
    name = path.rsplit("/", 1)[-1]
    limit = tol.get(name)
    if limit is None and tol and "/stats/" in path and a.dtype.kind == "f":
        limit = STATS_TOL
    if a.dtype.kind == "f" and limit is not None:
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=path)
        ok = ~np.isnan(a)
        d = float(np.max(np.abs(a[ok].astype(np.float64) - b[ok]))) if ok.any() else 0.0
        if err is not None:
            err[name] = max(err.get(name, 0.0), d)
        assert d <= limit, (path, d, limit)
    elif a.dtype.kind == "f":
        assert np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")), (
            path, np.nanmax(np.abs(a.astype(np.float64) - b)))
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def actions(rng, n: int | None, width: int | None, logits: bool):
    """One numpy action dict: uniform moves, uniform predictions (normal
    logits); ``width`` None is the masked prediction ``()``. ``n`` None is
    the single env's unbatched form."""
    shape = () if n is None else (n,)
    act = {"action": rng.uniform(-1, 1, (*shape, 2)).astype(np.float32)}
    if width is None:
        act["prediction"] = ()
    elif logits:
        act["prediction"] = rng.standard_normal((*shape, width)).astype(np.float32)
    else:
        act["prediction"] = rng.uniform(-1, 1, (*shape, width)).astype(np.float32)
    return act


def _prediction_width(env):
    space = env.single_action_space["prediction"] if hasattr(env, "single_action_space") \
        else env.action_space["prediction"]
    return space.shape[-1] if space.shape else None


def run_pair(env_id: str, n: int | None, steps: int, tol: dict | None = None, seed: int = 0,
             **overrides):
    """Seeded reference-mode runs of both packages from the same numpy
    actions: ``n`` envs through make_vec, or (``n`` None) make. Every reset
    and step output is compared with ``same_tree``. Returns (apx env, port
    env, max float differences, dones seen)."""
    if n is None:
        jenv = jc.make(env_id, **overrides)
        tenv = tc.make(env_id, device="cpu", **overrides)
    else:
        jenv = jc.make_vec(env_id, num_envs=n, **overrides)
        tenv = tc.make_vec(env_id, num_envs=n, device="cpu", **overrides)
    err: dict = {}
    same_tree(jenv.reset(seed=seed), tenv.reset(seed=seed), f"{env_id} reset", tol, err)
    width = _prediction_width(jenv)
    logits = env_id.startswith(("CircleSquare", "MNIST", "CIFAR", "DoubleCircle")) \
        and "Loc" not in env_id
    rng = np.random.default_rng(seed + 1)
    dones = 0
    for t in range(steps):
        act = actions(rng, n, width, logits)
        jout = jenv.step(act)
        tout = tenv.step(act)
        for name, a, b in zip(("obs", "reward", "terminated", "truncated", "info"), jout, tout):
            same_tree(a, b, f"{env_id} step {t}/{name}" if name != "reward"
                      else f"{env_id} step {t}/reward", tol, err)
        done = np.asarray(jout[2]) | np.asarray(jout[3])
        dones += int(np.sum(done))
        if n is None and done:
            same_tree(jenv.reset(), tenv.reset(), f"{env_id} reset after {t}", tol, err)
    return jenv, tenv, err, dones
