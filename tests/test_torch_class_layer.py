"""The reference's class layer on the port (apx_torch.compat.gym_classes,
gym_spaces, dataset_classes and ap_gym_alias) against apx's on the CPU.

Each case of tests/test_ap_gym_alias.py and of
tests/test_aux.py::test_ap_gym_alias_drives_reference_example_loop runs
once on apx's alias and once on the port's, on the same inputs, and the
observable results (observations, rewards, infos, spaces, losses, data)
must be equal; the port's registered envs run on the CPU
(``device="cpu"``). Both aliases install themselves as ``ap_gym``, so a
fixture saves every ``sys.modules["ap_gym*"]`` entry and restores it."""

import sys

import jax  # noqa: F401  (conftest pins the cpu backend)
import gymnasium as gym
import numpy as np
import pytest
import torch

import apx.compat as apx_compat
import apx_torch.compat as port_compat
from test_ap_gym_alias import REFERENCE_EXPORTS

torch.set_num_threads(1)

CPU = {"device": "cpu"}


@pytest.fixture()
def aliases():
    """``install(which)`` installs apx's ("apx") or the port's ("port")
    alias as ``ap_gym`` and returns it with the make kwargs its registered
    envs need; every ``ap_gym*`` module entry is restored afterwards."""
    saved = {k: v for k, v in sys.modules.items() if k == "ap_gym" or k.startswith("ap_gym.")}
    from apx.compat import ap_gym_alias as apx_alias
    from apx_torch.compat import ap_gym_alias as port_alias

    def install(which: str):
        for k in [k for k in sys.modules if k == "ap_gym" or k.startswith("ap_gym.")]:
            del sys.modules[k]
        mod = (apx_alias if which == "apx" else port_alias).install("ap_gym")
        return mod, ({} if which == "apx" else CPU)

    yield install
    for k in [k for k in sys.modules if k == "ap_gym" or k.startswith("ap_gym.")]:
        del sys.modules[k]
    sys.modules.update(saved)


def _both(install, scenario):
    """scenario(alias, make_kwargs) on apx's alias, then on the port's."""
    return [scenario(*install(which)) for which in ("apx", "port")]


def _same(a, b, path="out", tol=None):
    """Nested dicts / tuples / lists of arrays, scalars and strings equal,
    numpy dtypes included; with ``tol``, floats within it (ints, bools and
    strings still equal)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}", tol)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]", tol)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(b).dtype == a.dtype, (path, a.dtype, np.asarray(b).dtype)
        if tol is not None and np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif tol is not None and isinstance(a, float):
        assert type(b) is float and abs(a - b) <= tol, (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_alias_export_list_matches_apx(aliases):
    """The port's alias exports every name of the reference's list, and the
    same public names as apx's alias; ``ap_gym.envs.*`` the same trees."""
    names = []
    for which in ("apx", "port"):
        mod, _ = aliases(which)
        assert not [n for n in REFERENCE_EXPORTS if not hasattr(mod, n)]
        public = sorted(n for n in vars(mod) if not n.startswith("_"))
        subs = {sub: sorted(n for n in vars(getattr(mod.envs, sub)) if not n.startswith("_"))
                for sub in ("dataset", "image", "floor_map")}
        names.append((public, subs))
    assert names[0] == names[1]


class _ToyEnv(gym.Env):
    """Plain gymnasium env (no AP surface)."""

    observation_space = gym.spaces.Box(-1, 1, shape=(3,), dtype=np.float32)
    action_space = gym.spaces.Box(-1, 1, shape=(2,), dtype=np.float32)

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self._t = 0
        return np.zeros(3, np.float32), {}

    def step(self, action):
        self._t += 1
        return (np.full(3, self._t, np.float32), 0.5, self._t >= 5, False,
                {"custom": self._t})


def test_pseudo_wraps_plain_gym_env_as_apx(aliases):
    def scenario(alias, kw):
        env = alias.ensure_active_perception_env(_ToyEnv())
        assert isinstance(env, alias.PseudoActivePerceptionWrapper)
        out = [repr(env.prediction_space), repr(env.prediction_target_space),
               repr(env.action_space), env.reset(seed=0)]
        for _ in range(5):
            out.append(env.step({"action": np.zeros(2), "prediction": ()}))
        out.append(env.loss_fn((), (), ()))
        return out

    a, b = _both(aliases, scenario)
    _same(a, b)


def test_pseudo_wraps_plain_gym_vector_env_as_apx(aliases):
    def scenario(alias, kw):
        venv = gym.vector.SyncVectorEnv([_ToyEnv, _ToyEnv])
        wrapped = alias.ensure_active_perception_vector_env(venv)
        assert isinstance(wrapped, alias.PseudoActivePerceptionVectorWrapper)
        out = [repr(wrapped.single_action_space), repr(wrapped.action_space),
               repr(wrapped.prediction_target_space), wrapped.reset(seed=0)]
        for _ in range(6):
            out.append(wrapped.step({"action": np.zeros((2, 2), np.float32), "prediction": ()}))
        return out

    a, b = _both(aliases, scenario)
    _same(a, b)


def test_restore_digs_through_foreign_wrappers_as_apx(aliases):
    """A compat AP env behind a foreign gym wrapper is restored, not
    pseudo-wrapped; a SyncVectorEnv of compat singles is restored with
    batched spaces. Seeded LightDark episodes through both are apx's."""

    class Noop(gym.Wrapper):
        pass

    def scenario(alias, kw):
        apc = port_compat if kw else apx_compat
        inner = apc.make("LightDark-v0", **kw)
        env = alias.ensure_active_perception_env(Noop(inner))
        assert isinstance(env, alias.ActivePerceptionRestoreWrapper)
        assert env.loss_fn is inner.loss_fn
        out = [repr(env.prediction_target_space), repr(env.action_space), env.reset(seed=3)]
        rng = np.random.default_rng(0)
        for _ in range(4):
            act = {"action": rng.uniform(-1, 1, 2).astype(np.float32),
                   "prediction": rng.uniform(-1, 1, 2).astype(np.float32)}
            obs, r, te, tr, info = env.step(act)
            out.append((obs, r, te, tr, info["prediction"]["target"], info["base_reward"]))
        venv = gym.vector.SyncVectorEnv([lambda: apc.make("LightDark-v0", **kw)
                                         for _ in range(2)])
        restored = alias.ensure_active_perception_vector_env(venv)
        assert isinstance(restored, alias.ActivePerceptionVectorRestoreWrapper)
        assert isinstance(restored.single_action_space, alias.ActivePerceptionActionSpace)
        out += [repr(restored.prediction_target_space), repr(restored.single_action_space),
                restored.prediction_target_space.shape]
        return out

    a, b = _both(aliases, scenario)
    _same(a, b)


def _regression_env(alias, limit: int):
    class MyEnv(alias.ActiveRegressionEnv):
        def __init__(self):
            super().__init__(2, gym.spaces.Box(-1, 1, shape=(1,)))
            self.observation_space = gym.spaces.Box(-1, 1, shape=(1,))

        def reset(self, *, seed=None, options=None):
            super().reset(seed=seed)
            self._t = 0
            return np.zeros(1, np.float32), {}

        def _step(self, action, prediction):
            self._t += 1
            target = np.array([0.5, -0.5], np.float32)
            return np.zeros(1, np.float32), 2.0, self._t >= limit, False, {}, target

    return MyEnv


def test_user_subclass_and_register_as_apx(aliases):
    """A user subclass of the alias's ActiveRegressionEnv, registered: the
    step template (reward = base - loss, info rebuilt) and the -sparse
    twin's weighted loss, single and vector, equal apx's."""

    def scenario(alias, kw):
        alias.register(id="MyEnv-v0", entry_point=_regression_env(alias, 3))
        env = alias.make("MyEnv-v0")
        out = [env.reset(seed=0)]
        rng = np.random.default_rng(1)
        preds = [np.array([0.5, -0.5], np.float32)] + [
            rng.uniform(-1, 1, 2).astype(np.float32) for _ in range(2)]
        for pred in preds:
            out.append(env.step({"action": np.zeros(1, np.float32), "prediction": pred}))
        sparse = alias.make("MyEnv-sparse-v0")
        assert isinstance(sparse, alias.SparsifyWrapper)
        out.append(sparse.reset(seed=0))
        for pred in preds:
            out.append(sparse.step({"action": np.zeros(1, np.float32), "prediction": pred}))
        vec = alias.make_vec("MyEnv-sparse-v0", num_envs=2)
        assert isinstance(vec, alias.SparsifyVectorWrapper)
        out += [repr(vec.prediction_target_space), vec.reset(seed=0)]
        for pred in preds:
            out.append(vec.step({"action": np.zeros((2, 1), np.float32),
                                 "prediction": np.stack([pred, -pred])}))
        return out

    a, b = _both(aliases, scenario)
    _same(a, b)


def test_timelimit_semantics_as_apx(aliases):
    """TimeLimit with issue_termination: the time concatenated to a 1-D Box
    obs, the termination at the limit, and the dict and fallback forms."""

    def scenario(alias, kw):
        out = []
        for issue, observe in ((True, None), (False, True), (False, False)):
            env = alias.TimeLimit(alias.ensure_active_perception_env(_ToyEnv()),
                                  max_episode_steps=2, issue_termination=issue,
                                  observe_time_steps=observe)
            out += [repr(env.observation_space), env.reset(seed=0)]
            for _ in range(3):
                out.append(env.step({"action": np.zeros(2), "prediction": ()}))
        return out

    a, b = _both(aliases, scenario)
    _same(a, b)


def test_timelimit_spec_patching_as_apx(aliases):
    def scenario(alias, kw):
        env = alias.make("LightDark-v0", **kw)  # the registry's TimeLimit(50)
        wrapped = alias.TimeLimit(env, max_episode_steps=7)
        assert wrapped.spec is wrapped.spec  # cached
        return [env.spec.max_episode_steps, wrapped.spec.max_episode_steps,
                env.spec.max_episode_steps, dict(wrapped._saved_kwargs)]

    a, b = _both(aliases, scenario)
    _same(a, b)
    assert a[:3] == [50, 7, 50]


def test_sparse_twin_any_version_as_apx(aliases):
    """MyEnv-v3 gets MyEnv-sparse-v3 (parse_env_id/get_env_id)."""

    def scenario(alias, kw):
        alias.register(id="MyEnv-v3", entry_point=_regression_env(alias, 1))
        sparse = alias.make("MyEnv-sparse-v3")
        assert isinstance(sparse, alias.SparsifyWrapper)
        out = [sparse.reset(seed=0), sparse.step(
            {"action": np.zeros(1, np.float32), "prediction": np.zeros(2, np.float32)})]
        vec = alias.make_vec("MyEnv-sparse-v3", num_envs=2)
        assert isinstance(vec, alias.SparsifyVectorWrapper)
        out += [vec.reset(seed=0), vec.step({"action": np.zeros((2, 1), np.float32),
                                             "prediction": np.zeros((2, 2), np.float32)})]
        return out

    a, b = _both(aliases, scenario)
    _same(a, b)


def test_image_space_reference_ctor_as_apx(aliases):
    def scenario(alias, kw):
        sp = alias.ImageSpace(width=5, height=7, channels=1)
        batched = gym.vector.utils.batch_space(sp, 3)
        assert isinstance(batched, alias.ImageSpace)
        lg = gym.vector.utils.batch_space(alias.LogitSpace(-np.inf, np.inf, shape=(10,)), 2)
        assert isinstance(lg, alias.LogitSpace)
        ap = alias.ActivePerceptionActionSpace(sp, lg)
        bap = gym.vector.utils.batch_space(ap, 2)
        assert isinstance(bap, alias.ActivePerceptionActionSpace)
        return [sp.shape, (sp.width, sp.height, sp.channels), batched.shape,
                batched.batch_shape, lg.shape, repr(sp), repr(batched), repr(bap)]

    a, b = _both(aliases, scenario)
    _same(a, b)
    assert a[0] == (7, 5, 1) and a[2] == (3, 7, 5, 1)


def test_envs_submodule_tree_as_apx(aliases):
    """Reference-style imports from ``ap_gym.envs.*``: the datasets, the
    iterator's draws and the perception module driven from them equal
    apx's (the port's module on the CPU)."""

    def scenario(alias, kw):
        from ap_gym.envs.dataset import DatasetBatchIterator, DatasetIterator
        from ap_gym.envs.floor_map import FloorMapDataset, FloorMapDatasetMaze, FloorMapDatasetRooms
        from ap_gym.envs.image import (CircleSquareDataset, DoubleCircleSquareDataset,
                                       ImageClassificationDataset, ImagePerceptionConfig,
                                       ImagePerceptionModule)

        ds = CircleSquareDataset()
        assert isinstance(ds, ImageClassificationDataset)
        maze = FloorMapDatasetMaze()
        assert isinstance(maze, FloorMapDataset)
        out = [len(ds), ds.num_classes, ds[5], ds[[5, 9]],
               len(DoubleCircleSquareDataset(image_shape=(15, 15))),
               DoubleCircleSquareDataset(image_shape=(15, 15))[[0, 7, 100]],
               maze[3], FloorMapDatasetRooms()[[1, 2]]]
        out.append(next(DatasetIterator(ds, seed=11)))
        out.append(next(DatasetBatchIterator(ds, batch_size=3, seed=12)))
        mod = ImagePerceptionModule(2, ImagePerceptionConfig(dataset=ds, prefetch=False), **kw)
        mod.seed(0)
        out.append(mod.reset())
        out.append(mod.step(np.zeros((2, 2)), np.zeros(2)))
        mod.close()
        return out

    a, b = _both(aliases, scenario)
    _same(a, b)


def test_loss_classes_as_apx_and_jax_raises(aliases):
    """The loss classes' numpy forms and bounds equal apx's; the port's
    torch forms equal its numpy ones; ``jax()`` raises on the port and
    names apx.compat."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 3)).astype(np.float32)
    labels = np.array([0, 2, 1, 2])
    pred, target = rng.uniform(-1, 1, (4, 2)), rng.uniform(-1, 1, (4, 2))

    def scenario(alias, kw):
        ce = alias.CrossEntropyLossFn(num_classes=3)
        mse = alias.MSELossFn(target_std=0.5)
        lam = alias.LambdaLossFn(np=lambda p, t, b: np.abs(p - t).sum(-1),
                                 torch=lambda p, t, b: (p - t).abs().sum(-1))
        weighted = alias.WeightedLossFn(mse)
        return [ce.numpy(logits, labels), ce.normalized.numpy(logits, labels),
                ce.lower_bound, float(ce.blind_guessing_expected_value),
                mse.numpy(pred, target), mse.normalized.numpy(pred, target),
                lam.numpy(pred, target), alias.ZeroLossFn()((), (), (3,)),
                weighted.numpy(pred, {"target": target, "weight": np.array([1.0, 0, 1, 0])})]

    a, b = _both(aliases, scenario)
    _same(a, b)
    alias, _ = aliases("port")
    ce = alias.CrossEntropyLossFn(num_classes=3)
    np.testing.assert_allclose(
        ce.torch(torch.as_tensor(logits), torch.as_tensor(labels)).numpy(),
        ce.numpy(logits, labels), rtol=1e-6)
    lam = alias.LambdaLossFn(np=lambda p, t, b: np.abs(p - t).sum(-1),
                             torch=lambda p, t, b: (p - t).abs().sum(-1))
    np.testing.assert_array_equal(lam.torch(torch.as_tensor(pred), torch.as_tensor(target)),
                                  lam.numpy(pred, target))
    for loss in (ce, alias.MSELossFn(), alias.ZeroLossFn(), lam, ce.normalized):
        with pytest.raises(NotImplementedError, match="apx.compat"):
            loss.jax(logits, labels)


def test_reference_example_loop_as_apx(aliases):
    """The reference's example/circle_square.py core loop (test_aux's) on
    both aliases, with the spaces' samplers seeded alike: frames, spaces
    and the ints equal, glimpses within 2e-5 and losses within 1e-6, the
    image families' tolerances (tests/_compat_parity.py)."""

    def scenario(alias, kw):
        env = alias.make("CircleSquare-v0", render_mode="rgb_array", **kw)
        env.inner_action_space.seed(4)
        env.prediction_space.seed(5)
        obs, _ = env.reset(seed=0)
        out = [env.render(), repr(env.observation_space), env.metadata["render_fps"], obs]
        prev_done = False
        for _ in range(20):
            if prev_done:
                obs, _ = env.reset()
                prev_done = False
                out.append(obs)
            else:
                action = {"action": env.inner_action_space.sample(),
                          "prediction": env.prediction_space.sample()}
                obs, _, terminated, truncated, info = env.step(action)
                prev_done = terminated or truncated
                out += [obs, float(env.loss_fn.numpy(action["prediction"],
                                                     info["prediction"]["target"]))]
        out.append(env.render())
        env.close()
        return out

    a, b = _both(aliases, scenario)
    _same(a[:3], b[:3])
    _same(a[3:-1], b[3:-1], tol=2e-5)
    _same([x for x in a if isinstance(x, float)], [x for x in b if isinstance(x, float)], tol=1e-6)
    _same(a[-1], b[-1])


def test_compat_reexports_ensure():
    """``apx_torch.compat`` re-exports the ensure functions as apx.compat
    does, from the class layer."""
    from apx_torch.compat import gym_classes

    tc = port_compat
    assert tc.ensure_active_perception_env is gym_classes.ensure_active_perception_env
    assert tc.ensure_active_perception_vector_env is \
        gym_classes.ensure_active_perception_vector_env
    env = tc.make("LightDark-v0", device="cpu")
    assert tc.ensure_active_perception_env(env) is env
    with pytest.raises(AttributeError):
        tc.no_such_name  # noqa: B018
