"""Image localization and the unique-target sampler in the port against
apx (jitted, on the CPU).

The sampler ranks a float32 score, min over j != i of the pairwise mean
squared difference of candidate glimpses, from a Gram product. apx's (XLA's
dot) and the port's (torch's matmul) sum in different orders, so the scores
agree only to a tolerance, stated below with the measured drift, and the
top-k can reorder only where adjacent scores lie within it. The tests
therefore compare:

* the candidate grid, its axes and the candidates' hat weights bitwise;
* the scores within ``SCORE_TOL`` of the geometry;
* the top-k indices on every image whose ranking is decided: each gap
  between distinct scores among the first k + 1 is wider than twice the
  tolerance, no exact tie crosses the k-th place, and apx's exact ties
  within the top k (mutually nearest candidates, the usual case at the
  top) are exact in the port too; the test prints the smallest gap it
  relied on;
* an image of one colour, where every score ties, pinning the stable order;
* the trajectories: targets, ints and bools bitwise, rewards bitwise,
  glimpses and target glimpses within 1e-6. MNISTLoc's starts with the
  sampler, from a seed whose selected ranks are decided (asserted, smallest
  gap printed). TinyImageNet's synthetic textures are nearly periodic, so
  at its geometry the gaps at the selected ranks fall within the drift for
  most draws (none of 40 seeds at N = 4 clears it); its trajectory starts
  from apx's targets through the host-draw builder, and its sampler is held
  by the score and target tests.

The envs' count is a multiple of 4: apx's jitted loss rounds differently
in the scalar remainder of XLA's vectorised loop (at N = 3 every env's sum
of squares is contracted; at N = 4, 8 and 64 none is), and the port follows
the vector body.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apx
from apx.compat.builders import reset_from_draws as jax_reset_from_draws
from apx.envs.image_perception import ImagePerceptionEngine as JE

import apx_torch
from apx_torch.compat.builders import reset_from_draws
from apx_torch.convert import image_localization_state_from_numpy
from apx_torch.core.env import VectorState
from apx_torch.core import losses
from apx_torch.core.numerics import fma
from apx_torch.data.huggingface import synthetic_image_bank
from apx_torch.envs import image_perception as ip
from apx_torch.envs.image_localization import ImageLocalizationEnv
from apx_torch.envs.image_perception import ImagePerceptionEngine as TE

torch.set_num_threads(1)
TOL = 1e-6  # glimpses and target glimpses
# Score tolerances by geometry; measured max |diff| on these tests' images
# and the trajectories' reset images: MNIST 6.1e-7, CIFAR10 7.1e-7,
# TinyImageNet 1.73e-6.
SCORE_TOL = {"mnist": 1e-6, "cifar10": 1.5e-6, "zh-plus/tiny-imagenet": 3e-6}
GEOMETRY = {"mnist": ("MNISTLoc-v0", 529, 25), "cifar10": ("CIFAR10Loc-v0", 729, 75),
            "zh-plus/tiny-imagenet": ("TinyImageNetLoc-v0", 729, 300)}
K = 10


def _params(name):
    env_id = GEOMETRY[name][0]
    _, jp = apx.make(env_id)
    _, p = apx_torch.make(env_id, device="cpu")
    return jp, p


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_candidate_grid_and_weights_bitwise(name):
    jp, p = _params(name)
    grid, max_cell = TE.candidate_grid(p)
    jgrid, jmax = JE.candidate_grid(jp)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    np.testing.assert_array_equal(max_cell.numpy(), np.asarray(jmax))
    for ours, ref in zip(TE.candidate_axes(p), JE.candidate_axes(jp)):
        np.testing.assert_array_equal(ours, np.asarray(ref))
    _, npts, d = GEOMETRY[name]
    assert grid.shape == (npts, 2)
    h, w, c = p.dataset.image_shape
    assert p.sensor_size[0] * p.sensor_size[1] * c == d
    # The column weights: apx's _cartesian_factors returns them.
    perc = jax.tree_util.tree_map(lambda x: x[0], apx.make_vec(GEOMETRY[name][0], num_envs=1)[0]
                                  .reset(jax.random.PRNGKey(0), jp)[1].inner.perception)
    _, jw_cols = jax.jit(lambda pc: JE._cartesian_factors(pc, jp)[:2])(perc)
    np.testing.assert_array_equal(TE._candidate_weights(p)[1].numpy(), np.asarray(jw_cols))


def _images(name, n=6, seed=0):
    """n images of the registry's synthetic bank, and n uniform-random ones."""
    bank = synthetic_image_bank(name, num_points=512, device="cpu")
    rng = np.random.default_rng(seed)
    real = bank.images[torch.from_numpy(rng.integers(0, 512, n))]
    noise = torch.from_numpy(rng.integers(0, 256, real.shape, dtype=np.uint8))
    return torch.cat([real, noise]).numpy()


def _apx_scores(images, jp):
    def one(img):
        perc = JE.reset(jax.random.PRNGKey(0), jp).replace(image=img)
        return JE._min_pairwise_mse(JE._candidate_flat_cartesian(perc, jp))

    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(images)))


def _decided(u_ref, u_port, tol, k=K):
    """The smallest gap between distinct scores among apx's first k + 1,
    or None when the top-k is not decided: a gap within 2 tol, an exact tie
    across the k-th place, or one of apx's exact ties within the top k not
    exact in the port."""
    order = np.argsort(-u_ref, kind="stable")[:k + 1]
    s = u_ref[order]
    gaps = s[:-1] - s[1:]
    if gaps[-1] == 0:
        return None
    for i in np.flatnonzero(gaps == 0):
        if u_port[order[i]] != u_port[order[i + 1]]:
            return None
    live = gaps[gaps > 0]
    return live.min() if live.min() > 2 * tol else None


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_uniqueness_and_top_k_match_apx(name):
    jp, p = _params(name)
    images = _images(name)
    ref = _apx_scores(images, jp)
    ours = TE.uniqueness(torch.from_numpy(images), p).numpy()
    err = np.abs(ours - ref).max()
    assert err <= SCORE_TOL[name], err
    top = TE.unique_target_top_k(torch.from_numpy(images), p).numpy()
    gaps = [_decided(r, o, SCORE_TOL[name]) for r, o in zip(ref, ours)]
    decided = [i for i, g in enumerate(gaps) if g is not None]
    print(f"{name}: score max |diff| {err:.3g}; top-k compared on {len(decided)} of "
          f"{len(images)} images, smallest gap relied on "
          f"{min(gaps[i] for i in decided):.3g}")
    assert len(decided) >= len(images) // 3
    for i in decided:
        np.testing.assert_array_equal(top[i], np.argsort(-ref[i], kind="stable")[:K])


def test_ties_keep_the_lower_index():
    """An image of one colour: every candidate glimpse is the same, so
    every score ties, in apx and in the port; the stable sort keeps the
    grid's order."""
    jp, p = _params("zh-plus/tiny-imagenet")
    flat = np.full((2, 64, 64, 3), 93, np.uint8)
    flat[1] = 0
    ref = _apx_scores(flat, jp)
    ours = TE.uniqueness(torch.from_numpy(flat), p).numpy()
    assert (ref == ref[:, :1]).all() and (ours == ours[:, :1]).all()
    np.testing.assert_array_equal(TE.unique_target_top_k(torch.from_numpy(flat), p).numpy(),
                                  np.tile(np.arange(K), (2, 1)))
    for u in ref:
        np.testing.assert_array_equal(np.argsort(-u, kind="stable")[:K], np.arange(K))


@pytest.mark.parametrize("name", ["mnist", "zh-plus/tiny-imagenet"])
def test_targets_from_injected_draws_bitwise(name):
    """``unique_target_from_draws`` on images whose top-k is decided gives
    apx's targets bitwise, jitter and clip included."""
    jp, p = _params(name)
    images = _images(name, seed=3)
    ref = _apx_scores(images, jp)
    ours = TE.uniqueness(torch.from_numpy(images), p).numpy()
    keep = [i for i in range(len(images)) if _decided(ref[i], ours[i], SCORE_TOL[name])]
    images = images[keep]
    rng = np.random.default_rng(4)
    _, max_cell = JE.candidate_grid(jp)
    sel = rng.integers(0, K, len(keep))
    jitter = (rng.uniform(-1, 1, (len(keep), 2)) * np.asarray(max_cell) * 3).astype(np.float32)

    def one(img, s, j):
        perc = JE.reset(jax.random.PRNGKey(0), jp).replace(image=img)
        return JE.unique_target_from_draws(perc, s, j, jp)

    want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(images), jnp.asarray(sel),
                                              jnp.asarray(jitter)))
    got = TE.unique_target_from_draws(torch.from_numpy(images), torch.from_numpy(sel),
                                      torch.from_numpy(jitter), p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(want) == 1).any()  # the clip was reached


def _draw_fn(jp, n):
    """keys -> the draws apx's explicit reset and autoreset take from each
    key: (index, pos) of the perception reset, (sel, jitter) of the
    sampler, and the uniform autoreset target."""
    _, max_cell = JE.candidate_grid(jp)

    def one(key):
        k_reset, k_target = jax.random.split(key)
        k_idx, _, k_pos = jax.random.split(k_reset, 3)
        k_sel, k_jit = jax.random.split(k_target)
        return (jax.random.randint(k_idx, (), 0, jp.dataset.length, dtype=jnp.int32),
                jax.random.uniform(k_pos, (2,), minval=-1.0, maxval=1.0),
                jax.random.randint(k_sel, (), 0, jp.unique_sampling_top_k),
                jax.random.uniform(k_jit, (2,), minval=-max_cell, maxval=max_cell),
                jax.random.uniform(k_target, (2,), minval=-1.0, maxval=1.0))

    batched = jax.jit(jax.vmap(one))

    def draws(keys):
        idx, pos, sel, jit, target = (np.array(x) for x in batched(keys))
        return {"index": torch.from_numpy(idx.astype(np.int64)),
                "inverted": torch.zeros(n, dtype=torch.bool), "pos": torch.from_numpy(pos),
                "sel": torch.from_numpy(sel.astype(np.int64)), "jitter": torch.from_numpy(jit),
                "target": torch.from_numpy(target)}

    return draws


def _apx_trajectory(env_id, n, seed, steps):
    jvenv, jp = apx.make_vec(env_id, num_envs=n)
    draws = _draw_fn(jp, n)
    key = jax.random.PRNGKey(seed)
    first = (draws(jax.random.split(key, n)), jax.jit(jvenv.reset)(key, jp))
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(seed)
    js = first[1][1]
    traj = []
    for t in range(steps):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        pred = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        res = step(kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(pred)}, jp)
        traj.append((js, act, pred, draws(jax.random.split(jax.random.split(kt)[1], n)), res))
        js = res[1]
    return jp, first, traj


# id -> (envs, key seed, steps, explicit reset through the sampler).
TRAJECTORIES = {"MNISTLoc-v0": (8, 29, 34, True), "TinyImageNetLoc-v0": (4, 27, 17, False)}


@pytest.fixture(scope="module", params=list(TRAJECTORIES))
def apx_run(request):
    env_id = request.param
    return (env_id, *_apx_trajectory(env_id, *TRAJECTORIES[env_id][:3]))


def _close(a, b, what):
    err = np.abs(np.asarray(a, dtype=np.float64) - b.numpy()).max()
    assert err <= TOL, f"{what}: max |diff| {err}"


def test_lockstep_trajectory_matches_apx(apx_run):
    env_id, jp, (draws0, (jobs, js, _)), traj = apx_run
    n, _, _, sampler = TRAJECTORIES[env_id]
    venv, p = apx_torch.make_vec(env_id, n, device="cpu")
    if sampler:  # the selected ranks of the explicit reset are decided
        ref = _apx_scores(np.asarray(js.inner.perception.image), jp)
        gaps = []
        for u, sel in zip(ref, draws0["sel"].numpy()):
            srt = np.sort(u)[::-1]
            gaps.append(min([srt[sel] - srt[sel + 1]] + ([srt[sel - 1] - srt[sel]] if sel else [])))
        print(f"{env_id}: smallest gap at the selected ranks {min(gaps):.3g}")
        assert min(gaps) > 2 * SCORE_TOL["mnist"]
        obs, s, _ = venv.reset(p, draws=draws0)
    else:
        obs, inner, _ = reset_from_draws(venv.env, {**draws0, "target": js.inner.target}, p)
        s = VectorState(inner=inner, prev_done=torch.zeros(n, dtype=torch.bool))
    np.testing.assert_array_equal(s.inner.target.numpy(), np.asarray(js.inner.target))
    _close(jobs["target_glimpse"], obs["target_glimpse"], "reset target glimpse")
    resets = 0
    for t, (jprev, act, pred, draws, (jobs, js, jr, jte, jtr, jinfo)) in enumerate(traj):
        obs, s, r, te, tr, info = venv.step(
            s, {"action": torch.from_numpy(act), "prediction": torch.from_numpy(pred)}, p,
            reset_draws=draws)
        what = f"{env_id} step {t}"
        np.testing.assert_array_equal(s.inner.target.numpy(), np.asarray(js.inner.target), what)
        np.testing.assert_array_equal(s.inner.perception.pos.numpy(),
                                      np.asarray(js.inner.perception.pos), what)
        np.testing.assert_array_equal(s.inner.perception.data_index.numpy(),
                                      np.asarray(js.inner.perception.data_index), what)
        np.testing.assert_array_equal(te.numpy(), np.asarray(jte), what)
        np.testing.assert_array_equal(obs["time_step"].numpy(), np.asarray(jobs["time_step"]))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr), f"{what} reward")
        _close(jobs["glimpse"], obs["glimpse"], f"{what} glimpse")
        _close(jobs["target_glimpse"], obs["target_glimpse"], f"{what} target glimpse")
        np.testing.assert_array_equal(info["prediction"]["target"].numpy(),
                                      np.asarray(jinfo["prediction"]["target"]))
        if (s.inner.perception.time == 0).all():  # the reset step: loss against the old target
            resets += 1
            np.testing.assert_array_equal(info["prediction"]["target"].numpy(),
                                          np.asarray(jprev.inner.target))
    assert resets == len(traj) // (p.step_limit + 1)


def _steps_differing(jp, traj, env_id):
    """Steps (each from apx's own pre-step state) whose reward differs."""
    n = TRAJECTORIES[env_id][0]
    venv, p = apx_torch.make_vec(env_id, n, device="cpu")
    bad = 0
    for jprev, act, pred, draws, (_, _, jr, *_) in traj:
        i = jprev.inner
        pc = i.perception
        s = image_localization_state_from_numpy(pc.image, pc.label, pc.data_index, pc.pos, pc.time,
                                                pc.label_inverted, i.target, i.target_glimpse,
                                                jprev.prev_done, device="cpu")
        _, _, r, *_ = venv.step(s, {"action": torch.from_numpy(act),
                                    "prediction": torch.from_numpy(pred)}, p, reset_draws=draws)
        bad += not np.array_equal(r.numpy(), np.asarray(jr))
    return bad


def _exact_flat(seed=0):
    """Candidate glimpses on a grid of 1/16: every product and partial sum
    of the Gram product is exact, so only the score's last rounding
    differs between the forms."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 17, (3, 40, 24)) / 16).astype(np.float32)


def _mse_division(flat):
    n, p, d = flat.shape
    sq = (flat * flat).sum(-1)
    g = flat @ flat.transpose(1, 2)
    diff = (sq[:, :, None] + sq[:, None, :] - 2.0 * g) / torch.tensor(np.float32(d))
    return torch.where(torch.eye(p, dtype=torch.bool), float("inf"), diff).amin(-1)


def _weights_fused(params):
    h, w, _ = params.dataset.image_shape
    xs, ys = TE.candidate_axes(params)
    lim = ip.sensor_pos_lim_pixels((h, w), params.sensor_size, params.sensor_scale)
    x_pix = fma(torch.from_numpy(xs), torch.tensor(float(lim[0])), (w - 1) / 2.0)
    y_pix = fma(torch.from_numpy(ys), torch.tensor(float(lim[1])), (h - 1) / 2.0)
    off0 = torch.arange(params.sensor_size[0], dtype=torch.float32) - (params.sensor_size[0] - 1) / 2
    off1 = torch.arange(params.sensor_size[1], dtype=torch.float32) - (params.sensor_size[1] - 1) / 2
    return (ip.interp_weights(y_pix[:, None] + off0, h),
            ip.interp_weights(x_pix[:, None] + off1, w))


def _scale_division(image, params):
    tmp, w_cols = _ORIGINAL_FACTORS(image.to(torch.float32), params)
    return tmp / torch.tensor(np.float32(255.0)), w_cols


_ORIGINAL_FACTORS = TE._cartesian_factors


def _loss_contracted(self, params):
    return losses.AffineLossFn(
        inner=losses.MSELossFn(fused_sum=True, contract_reward=True), scale=3.0)


def _reward_uncontracted(self, params):
    return losses.AffineLossFn(inner=losses.MSELossFn(fused_sum=False), scale=3.0)


_SITES = {
    "centre pixels: multiply and add apart -> fma": "weights",
    "uint8 scale * f32(1/255) -> / 255": "scale",
    "score * f32(1/d) -> / d": "score",
    "loss squares unfused -> contracted": "steps",
    "reward fma(-sum, 1.5, base) -> base - loss": "steps",
}


@pytest.fixture(scope="module")
def mnist_run():
    return _apx_trajectory("MNISTLoc-v0", *TRAJECTORIES["MNISTLoc-v0"][:3])


@pytest.mark.parametrize("site", ["as written", *_SITES])
def test_image_localization_rounding_sites(mnist_run, monkeypatch, site):
    """Each site as written equals apx's jitted form bitwise, where that
    form can be isolated: the candidates' column weights, the row product
    at a candidate row of integral coordinates (a hat weight of exactly 1,
    so the product is the scaled image), the score on exact Gram products,
    and the step rewards from apx's own states. Written any other way,
    each differs."""
    jp, _, traj = mnist_run
    _, p = _params("mnist")
    kind = _SITES.get(site)
    if kind == "weights":
        monkeypatch.setattr(TE, "_candidate_weights", staticmethod(_weights_fused))
    elif kind == "scale":
        monkeypatch.setattr(TE, "_cartesian_factors", staticmethod(_scale_division))
    elif kind == "score":
        monkeypatch.setattr(TE, "_min_pairwise_mse", staticmethod(_mse_division))
    elif site.startswith("loss"):
        monkeypatch.setattr(ImageLocalizationEnv, "loss_fn", _loss_contracted)
    elif site.startswith("reward"):
        monkeypatch.setattr(ImageLocalizationEnv, "loss_fn", _reward_uncontracted)
    same = {}
    perc = jax.tree_util.tree_map(lambda x: x[:1], mnist_run[1][1][1].inner.perception)
    perc0 = jax.tree_util.tree_map(lambda x: x[0], perc)
    jtmp, jw_cols = jax.jit(lambda pc: JE._cartesian_factors(pc, jp)[:2])(perc0)
    w_rows, w_cols = TE._candidate_weights(p)
    same["weights"] = np.array_equal(w_cols.numpy(), np.asarray(jw_cols))
    image = torch.from_numpy(np.array(perc.image))
    tmp, _ = TE._cartesian_factors(image, p)
    assert (w_rows[0].max(-1).values == 1).all()  # candidate row 0: y = -1, integral rows
    same["scale"] = np.array_equal(tmp[0, 0].numpy(), np.asarray(jtmp)[0])
    flat = _exact_flat()
    jmse = np.asarray(jax.jit(jax.vmap(JE._min_pairwise_mse))(jnp.asarray(flat)))
    same["score"] = np.array_equal(TE._min_pairwise_mse(torch.from_numpy(flat)).numpy(), jmse)
    same["steps"] = _steps_differing(jp, traj, "MNISTLoc-v0") == 0
    if kind is None:
        assert all(same.values()), same
    else:
        assert not same[kind] and all(v for k, v in same.items() if k != kind), same


def test_reset_from_host_draws_matches_apx_builder():
    """The compat builder takes the target from the draws (resolved on the
    host) and runs no sweep."""
    jvenv, jp = apx.make_vec("MNISTLoc-v0", num_envs=3)
    venv, p = apx_torch.make_vec("MNISTLoc-v0", 3, device="cpu")
    draws = {"index": np.array([0, 7, 8191], np.int32), "inverted": np.zeros(3, bool),
             "pos": np.array([[-1, -1], [0.25, -0.5], [0.9, 0.1]], np.float32),
             "target": np.array([[1, 1], [-0.3, 0.7], [0.05, -1]], np.float32)}
    jobs, js, jinfo = jax.jit(lambda d: jax_reset_from_draws(jvenv.env, d, jp))(draws)
    obs, s, info = reset_from_draws(venv.env, draws, p)
    np.testing.assert_array_equal(s.target.numpy(), np.asarray(js.target))
    _close(jobs["target_glimpse"], obs["target_glimpse"], "target glimpse")
    _close(jobs["glimpse"], obs["glimpse"], "glimpse")
    np.testing.assert_array_equal(info["index"].numpy(), np.asarray(jinfo["index"]))


def test_autoreset_never_runs_the_sweep(monkeypatch):
    """The vector step runs the autoreset for all envs every step: it draws
    the target uniformly and must not reach the sampler."""
    venv, p = apx_torch.make_vec("MNISTLoc-v0", 4, device="cpu", step_limit=2)
    g = torch.Generator().manual_seed(0)
    obs, s, _ = venv.reset(p, g)

    def boom(*args, **kwargs):
        raise AssertionError("the sweep ran")

    monkeypatch.setattr(TE, "uniqueness", staticmethod(boom))
    act = {"action": torch.zeros(4, 2), "prediction": torch.zeros(4, 2)}
    for _ in range(3):
        old = s.inner.target
        obs, s, r, te, tr, info = venv.step(s, act, p, g)
    assert (s.inner.perception.time == 0).all()
    assert torch.equal(info["prediction"]["target"], old)  # the old target on the reset step
    # Zero predictions: base 0 less 3 * mean(target^2), at most 3.
    assert ((r <= 0) & (r >= -3)).all()
    venv.boundary_reset_step(s, act, p, g)


def test_native_draws_in_range():
    venv, p = apx_torch.make_vec("TinyImageNetLoc-v0", 512, device="cpu")
    _, max_cell = TE.candidate_grid(p)
    d = venv.env.draw_reset(512, p, torch.Generator().manual_seed(1))
    assert set(d) == {"index", "inverted", "pos", "sel", "jitter", "target"}
    assert d["sel"].min() >= 0 and d["sel"].max() < K and d["sel"].unique().numel() == K
    assert (d["jitter"].abs() <= max_cell).all() and (d["jitter"].abs().amax(0) > 0.8 * max_cell).all()
    assert d["target"].min() >= -1 and d["target"].max() < 1 and d["target"].std() > 0.5
    obs, s, _ = venv.reset(p, draws=d)
    assert obs["target_glimpse"].shape == (512, 10, 10, 3)
    assert ((obs["target_glimpse"] >= 0) & (obs["target_glimpse"] <= 1)).all()


def test_unported_sampler_options_raise():
    """apx's sampler backends are accepted and keep apx's meaning (the
    scores are held in test_torch_image_storage.py); an unknown one raises
    apx's ValueError."""
    for backend in ("chunked", "streamed", "cartesian", "auto"):
        venv, p = apx_torch.make_vec("MNISTLoc-v0", 4, device="cpu",
                                     unique_sampling_backend=backend)
        assert p.unique_sampling_backend == backend
        _, s, _ = venv.reset(p, torch.Generator().manual_seed(0))
        assert (s.inner.target.abs() <= 1).all()
    with pytest.raises(ValueError):
        apx_torch.make_vec("MNISTLoc-v0", 2, device="cpu", unique_sampling_backend="dense")
    for prec in ("default", "high", "highest"):  # a TPU setting: the port computes float32
        apx_torch.make_vec("MNISTLoc-v0", 2, device="cpu", glimpse_precision=prec)
