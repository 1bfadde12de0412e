"""apx's image A/B surfaces in the port: the packed bank and
``unpack_rows``, the ``image_storage`` modes, the row-band glimpse
``glimpse_window="rows"`` and the ``"chunked"`` and ``"streamed"``
unique-target samplers, each against apx (jitted, on the CPU) and
against the port's default form.

Storage modes and the row band are bitwise the port's defaults ("array",
"off") on every leaf (apx's tests/test_env_core.py:335 and
tests/test_glimpse.py:172 pin the same in apx); against apx the state
leaves are bitwise and the glimpses within 1e-6, as in
test_torch_image_env.py. The samplers' scores are float32 Gram products
summed in other orders: they are held within the score tolerances of
test_torch_image_localization.py (or apx's own, where tighter), with the
top-k compared wherever the score gaps decide it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_image_env import _check_obs, _close, _draw_fn, _eq
from test_torch_image_localization import GEOMETRY, K, SCORE_TOL, _decided, _images, _params

import apx
from apx.data.dataset import BankImageDataset as JaxBank
from apx.data.dataset import unpack_rows as jax_unpack_rows
from apx.envs.image_perception import ImagePerceptionEngine as JE

import apx_torch
from apx_torch.convert import image_bank_from_numpy, image_state_from_numpy
from apx_torch.core.env import AutoResetMode, rollout_episodic, vector_env
from apx_torch.data.dataset import BankImageDataset, pack_rows_u8, unpack_rows
from apx_torch.data.huggingface import synthetic_image_bank
from apx_torch.envs.image_localization import ImageLocalizationEnv
from apx_torch.envs.image_perception import ImagePerceptionEngine as TE
from apx_torch.ops._launch import launched
from apx_torch.ops.glimpse import extract_glimpse_batch

torch.set_num_threads(1)
MODES = ("array", "packed", "flat", "gather")


def test_unpack_rows_matches_apx():
    rng = np.random.default_rng(0)
    words = rng.integers(-2**31, 2**31, (5, 3, 196), dtype=np.int64).astype(np.int32)
    words[0, 0, :4] = [-1, 0, 2**31 - 1, -2**31]
    got = unpack_rows(torch.from_numpy(words), (28, 28, 1))
    want = jax.jit(jax_unpack_rows, static_argnums=1)(jnp.asarray(words), (28, 28, 1))
    assert got.dtype == torch.uint8 and got.shape == (5, 3, 28, 28, 1)
    _eq(want, got, "unpack_rows")
    # Packing is numpy's byte view, as apx packs its banks.
    images = torch.from_numpy(rng.integers(0, 256, (7, 8, 6, 3), dtype=np.uint8))
    packed = pack_rows_u8(images)
    np.testing.assert_array_equal(packed.numpy(), images.numpy().reshape(7, -1).view(np.int32))
    assert torch.equal(unpack_rows(packed, (8, 6, 3)), images)


def test_packed_bank_matches_apx():
    """``from_numpy(pack=True)`` holds apx's words; fetches (raw, stored,
    labels) equal apx's; the unpacked bank stores the same words; a float
    bank has no packed form."""
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (40, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 40)
    jb = JaxBank.from_numpy(images, labels, 10)
    packed = BankImageDataset.from_numpy(images, labels, 10, device="cpu", pack=True)
    plain = BankImageDataset.from_numpy(images, labels, 10, device="cpu")
    assert packed.packed_shape == jb.packed_shape == (28, 28, 1) and plain.packed_shape is None
    _eq(jb.images, packed.images, "packed words")
    idx = rng.integers(0, 40, 16)
    jraw, jlab = jb.fetch_raw(jnp.asarray(idx))
    jst, _ = jb.fetch_stored(jnp.asarray(idx))
    for bank in (packed, plain):
        assert bank.image_shape == (28, 28, 1) and bank.stored_packed_shape == (28, 28, 1)
        raw, lab = bank.fetch_raw(torch.from_numpy(idx))
        _eq(jraw, raw, "fetch_raw")
        _eq(np.asarray(jlab).astype(np.int64), lab, "labels")
        _eq(jst, bank.fetch_stored(torch.from_numpy(idx))[0], "fetch_stored")
        assert torch.equal(bank.glimpse_images()[torch.from_numpy(idx)], raw)
    assert packed.glimpse_images().data_ptr() == packed.images.data_ptr()  # a view
    conv = image_bank_from_numpy(np.asarray(jb.images), labels, 10, packed_shape=(28, 28, 1),
                                 device="cpu", pack=True)
    assert torch.equal(conv.images, packed.images) and conv.packed_shape == (28, 28, 1)
    conv = image_bank_from_numpy(np.asarray(jb.images), labels, 10, packed_shape=(28, 28, 1),
                                 device="cpu")
    assert torch.equal(conv.images, plain.images)
    f32 = BankImageDataset.from_numpy(images.astype(np.float32), labels, 10, device="cpu",
                                      pack=True)
    assert f32.packed_shape is None and f32.stored_packed_shape is None


@pytest.mark.parametrize("mode", MODES)
def test_storage_trajectory_matches_apx(mode):
    """MNIST-v0 under LOCKSTEP for three cycles in each storage mode: the
    image leaf bitwise apx's leaf of the same mode, the rest as
    test_torch_image_env; and bitwise the port's "array" run."""
    n = 16
    jvenv, jp = apx.make_vec("MNIST-v0", num_envs=n, image_storage=mode)
    runs = [apx_torch.make_vec("MNIST-v0", n, device="cpu", image_storage=m)
            for m in (mode, "array")]
    assert TE.storage(runs[0][1]) == JE.storage(jp) == mode
    key = jax.random.PRNGKey(5)
    jobs, js, _ = jax.jit(jvenv.reset)(key, jp)
    draws = _draw_fn(jp)
    carry = [venv.reset(p, draws=draws(jax.random.split(key, n)))[:2] for venv, p in runs]
    _check_obs(jobs, carry[0][0], "reset")
    step = jax.jit(jvenv.step)
    rng = np.random.default_rng(1)
    for t in range(3 * 17):
        kt = jax.random.fold_in(key, t)
        act = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        logits = rng.standard_normal((n, 10)).astype(np.float32)
        jobs, js, jr, jte, *_ = step(
            kt, js, {"action": jnp.asarray(act), "prediction": jnp.asarray(logits)}, jp)
        rd = draws(jax.random.split(jax.random.split(kt)[1], n))
        full = {"action": torch.from_numpy(act), "prediction": torch.from_numpy(logits)}
        outs = [venv.step(c[1], full, p, reset_draws=rd) for c, (venv, p) in zip(carry, runs)]
        carry = [o[:2] for o in outs]
        (obs, s, r, te, *_), (obs_a, s_a, r_a, te_a, *_) = outs
        what = f"{mode} step {t}"
        _check_obs(jobs, obs, what)
        _eq(js.inner.image, s.inner.image, f"{what} image leaf")
        _eq(js.inner.pos, s.inner.pos, f"{what} pos")
        _eq(np.asarray(js.inner.data_index).astype(np.int64), s.inner.data_index, what)
        _eq(jte, te, f"{what} terminated")
        _close(jr, r, f"{what} reward")
        for k in obs:
            assert torch.equal(obs[k], obs_a[k]), f"{what} {k} vs array"
        assert torch.equal(r, r_a) and torch.equal(te, te_a)
        assert torch.equal(TE.image_raw(s.inner, runs[0][1]), s_a.inner.image)
    # apx's state converts across with its leaf form.
    ji = js.inner
    conv = image_state_from_numpy(ji.image, ji.label, ji.data_index, ji.pos, ji.time,
                                  ji.label_inverted, js.prev_done, device="cpu")
    assert torch.equal(conv.inner.image, s.inner.image)


def test_storage_modes_bitwise_on_localization():
    """apx's test_image_storage_modes_bitwise_equal on the port: an
    ImageLocalizationEnv over a 64-image MNIST bank, step_limit 4, N=8,
    ``rollout_episodic`` for 11 steps in every mode, all bitwise the
    "array" run; the logical image is (8, 28, 28, 1) uint8 in each."""
    env = ImageLocalizationEnv(dataset=synthetic_image_bank("mnist", num_points=64,
                                                            device="cpu"))

    def pol(g, obs):
        return {"action": torch.rand((8, 2), generator=g) * 2 - 1,
                "prediction": torch.zeros((8, 2))}

    outs = {}
    for mode in MODES:
        params = env.default_params(image_storage=mode, step_limit=4)
        assert TE.storage(params) == mode
        venv = vector_env(env, 8, AutoResetMode.LOCKSTEP)
        obs, state, traj = rollout_episodic(venv, params, pol, torch.Generator().manual_seed(0),
                                            11, 4)
        img = TE.image_raw(state.inner.perception, params)
        assert img.shape == (8, 28, 28, 1) and img.dtype == torch.uint8
        outs[mode] = (obs, traj)
    for mode in MODES[1:]:
        for k in outs["array"][0]:
            assert torch.equal(outs[mode][0][k], outs["array"][0][k]), (mode, k)
        for a, b in zip(outs["array"][1], outs[mode][1]):
            assert torch.equal(a, b), mode


def test_gather_and_packed_glimpses_read_without_copies():
    """Under "gather" K3 reads the bank's rows through its index; under
    "packed" it reads the words' bytes in place."""
    venv, p = apx_torch.make_vec("MNIST-v0", 8, device="cpu", image_storage="gather")
    _, s, _ = venv.reset(p, torch.Generator().manual_seed(0))
    images, index = TE.glimpse_source(s.inner, p)
    assert images.data_ptr() == p.dataset.images.data_ptr() and torch.equal(index,
                                                                            s.inner.data_index)
    assert s.inner.image.shape == (8, 0)
    venv, p = apx_torch.make_vec("MNIST-v0", 8, device="cpu", image_storage="packed")
    _, s, _ = venv.reset(p, torch.Generator().manual_seed(0))
    images, index = TE.glimpse_source(s.inner, p)
    assert index is None and images.data_ptr() == s.inner.image.data_ptr()
    assert s.inner.image.dtype == torch.int32 and s.inner.image.shape == (8, 196)


@pytest.mark.parametrize("shape,sensor,scale", [((64, 64, 3), (10, 10), 1.0),
                                                ((28, 28, 1), (5, 5), 1.0),
                                                ((33, 47, 3), (4, 7), 2.5)])
def test_row_window_bitwise_off(shape, sensor, scale):
    """apx's test_row_window_bitwise_identical on the port: ``window="rows"``
    is bitwise ``"off"`` for random and edge positions, both image dtypes;
    within 1e-6 of apx's row form."""
    from apx.ops.glimpse import extract_glimpse_batch as jax_glimpse

    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (64, *shape), dtype=np.uint8)
    pos = np.concatenate([rng.uniform(-1, 1, (60, 2)),
                          [[1, 1], [-1, -1], [-1, 1], [0, 0]]]).astype(np.float32)
    t_pos = torch.from_numpy(pos)
    for im in (torch.from_numpy(imgs), torch.from_numpy(imgs).float() / 255):
        off = extract_glimpse_batch(im, t_pos, sensor, scale, window="off")
        rows = extract_glimpse_batch(im, t_pos, sensor, scale, window="rows")
        assert torch.equal(off, rows)
    want = jax_glimpse(jnp.asarray(imgs), jnp.asarray(pos), sensor, scale, window="rows")
    _close(want, extract_glimpse_batch(torch.from_numpy(imgs), t_pos, sensor, scale, "rows"),
           "rows vs apx")


def test_row_window_env_bitwise_off():
    """MNISTLoc-v0 with ``glimpse_window="rows"`` steps bitwise as with
    "off"; the row band is plain PyTorch, so K3 is not launched."""
    n = 8
    runs = [apx_torch.make_vec("MNISTLoc-v0", n, device="cpu", glimpse_window=w)
            for w in ("rows", "auto")]
    assert [TE.resolved_glimpse_window(p) for _, p in runs] == ["rows", "off"]
    g = torch.Generator().manual_seed(2)
    draws = runs[0][0].env.draw_reset(n, runs[0][1], g)
    carry = [venv.reset(p, draws=draws)[:2] for venv, p in runs]
    for t in range(20):
        act = {"action": torch.rand((n, 2), generator=g) * 2 - 1, "prediction": torch.zeros(n, 2)}
        rd = runs[0][0].env.draw_reset(n, runs[0][1], g)
        outs = [venv.step(c[1], act, p, reset_draws=rd) for c, (venv, p) in zip(carry, runs)]
        carry = [o[:2] for o in outs]
        for k in outs[0][0]:
            assert torch.equal(outs[0][0][k], outs[1][0][k]), (t, k)
        assert torch.equal(outs[0][2], outs[1][2])


def _apx_scores_by(images, jp, backend):
    jp = jp.replace(unique_sampling_backend=backend)

    def one(img):
        perc = JE.reset(jax.random.PRNGKey(0), jp).replace(image=img)
        if backend == "streamed":
            return JE._unique_scores_streamed(perc, jp)
        return JE._min_pairwise_mse(JE._candidate_flat_chunked(perc, jp))

    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(images)))


@pytest.mark.parametrize("name", ["mnist", "zh-plus/tiny-imagenet"])
def test_chunked_sampler_matches_apx(name):
    """The chunked candidate glimpses within 1e-5 of the port's cartesian
    ones (apx's test_candidate_sweep_backends_agree) and of apx's chunked
    ones; the scores within the geometry's tolerance of apx's chunked
    scores; the top-k equal wherever the gaps decide it."""
    jp, p = _params(name)
    images = _images(name)
    t_img = torch.from_numpy(images)
    chunked = TE._candidate_flat_chunked(t_img, p)
    cart = TE._candidate_flat(t_img, p)
    assert chunked.shape == cart.shape == (len(images), *GEOMETRY[name][1:])
    assert float((chunked - cart).abs().max()) <= 1e-5

    def apx_flat(img):
        perc = JE.reset(jax.random.PRNGKey(0), jp).replace(image=img)
        return JE._candidate_flat_chunked(perc, jp)

    jflat = np.asarray(jax.jit(jax.vmap(apx_flat))(jnp.asarray(images[:2])))
    assert np.abs(jflat - chunked[:2].numpy()).max() <= 1e-5
    pc = apx_torch.make("MNISTLoc-v0" if name == "mnist" else "TinyImageNetLoc-v0",
                        device="cpu", unique_sampling_backend="chunked")[1]
    before = launched("K3")
    ours = TE.uniqueness(t_img, pc).numpy()
    assert launched("K3") == before  # CPU tensors: the plain form
    ref = _apx_scores_by(images, jp, "chunked")
    err = np.abs(ours - ref).max()
    assert err <= SCORE_TOL[name], err
    _top_k_where_decided(TE.unique_target_top_k(t_img, pc).numpy(), ref, ours, SCORE_TOL[name],
                         f"{name} chunked", err)


@pytest.mark.parametrize("name", ["mnist", "zh-plus/tiny-imagenet"])
def test_streamed_sampler_matches_apx(name):
    """The streamed scores within the geometry's tolerance of apx's
    streamed scores and of the port's cartesian ones (apx pins 2e-6 between
    its two at CircleSquare's geometry); the top-k equal wherever the gaps
    decide it."""
    jp, p = _params(name)
    images = _images(name)
    t_img = torch.from_numpy(images)
    ps = apx_torch.make("MNISTLoc-v0" if name == "mnist" else "TinyImageNetLoc-v0",
                        device="cpu", unique_sampling_backend="streamed")[1]
    ours = TE.uniqueness(t_img, ps).numpy()
    cart = TE.uniqueness(t_img, p).numpy()
    tol = SCORE_TOL[name]
    assert np.abs(ours - cart).max() <= tol
    ref = _apx_scores_by(images, jp, "streamed")
    err = np.abs(ours - ref).max()
    assert err <= tol, err
    _top_k_where_decided(TE.unique_target_top_k(t_img, ps).numpy(), ref, ours, tol,
                         f"{name} streamed", err)


def _top_k_where_decided(top, ref, ours, tol, what, err):
    gaps = [_decided(r, o, tol) for r, o in zip(ref, ours)]
    decided = [i for i, g in enumerate(gaps) if g is not None]
    print(f"{what}: score max |diff| {err:.3g}; top-k compared on {len(decided)} of "
          f"{len(ref)} images, smallest gap relied on {min(gaps[i] for i in decided):.3g}")
    assert len(decided) >= len(ref) // 3
    for i in decided:
        np.testing.assert_array_equal(top[i], np.argsort(-ref[i], kind="stable")[:K])


def test_streamed_and_chunked_explicit_reset():
    """TinyImageNetLoc-v0's explicit reset under each sampler: the targets
    are the cartesian reset's wherever the top-k is decided (a uniform
    image: every score ties, so the stable order decides)."""
    n = 4
    runs = {b: apx_torch.make_vec("TinyImageNetLoc-v0", n, device="cpu",
                                  unique_sampling_backend=b)
            for b in ("auto", "chunked", "streamed")}
    venv, p = runs["auto"]
    draws = venv.env.draw_reset(n, p, torch.Generator().manual_seed(4))
    targets = {b: v.reset(q, draws=draws)[1].inner.target for b, (v, q) in runs.items()}
    flat = torch.full((n, 64, 64, 3), 77, dtype=torch.uint8)
    for b, (_, q) in runs.items():
        assert targets[b].shape == (n, 2) and (targets[b].abs() <= 1).all()
        np.testing.assert_array_equal(TE.unique_target_top_k(flat, q).numpy(),
                                      np.tile(np.arange(K), (n, 1)))
