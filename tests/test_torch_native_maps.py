"""apx_torch's native map banks are bitwise the JAX package's
``backend="native"`` banks, and ``MapBank.fetch_halves`` is bitwise apx's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apx.data import floor_map as jfm
from apx.data.native import native_available as apx_native_available

from apx_torch.data import floor_map as tfm
from apx_torch.data import native as tnative

torch.set_num_threads(1)


def _assert_bank_equal(ours, ref):
    np.testing.assert_array_equal(ours.maps.numpy(), np.asarray(ref.maps))
    np.testing.assert_array_equal(ours.indices.numpy(), np.asarray(ref.indices).astype(np.int64))
    np.testing.assert_array_equal(ours.free_counts.numpy(), np.asarray(ref.free_counts))
    np.testing.assert_array_equal(ours.free_cells.numpy(), np.asarray(ref.free_cells))
    np.testing.assert_array_equal(ours.row_words.numpy(), np.asarray(ref.row_words).astype(np.int64))
    assert ours.kind == ref.kind and ours.map_hw == ref.map_hw


def test_the_port_builds_its_own_library():
    assert tnative.native_available()
    assert tnative.SO.parent.name == "_build" and tnative.SO.exists()
    assert tnative.SRC.parent.name == "csrc"
    assert apx_native_available()


@pytest.mark.parametrize("kind", ["rooms", "maze"])
def test_native_bank_bitwise(kind):
    mk_t = tfm.make_rooms_bank if kind == "rooms" else tfm.make_maze_bank
    mk_j = jfm.make_rooms_bank if kind == "rooms" else jfm.make_maze_bank
    ours = mk_t(num_maps=256, seed=0, backend="native", device="cpu")
    ref = mk_j(num_maps=256, seed=0, backend="native")
    assert ours.map_hw == ((32, 32) if kind == "rooms" else (21, 21))
    _assert_bank_equal(ours, ref)
    python = mk_t(num_maps=256, seed=0, device="cpu")
    assert not torch.equal(ours.maps, python.maps)  # another map family per index


@pytest.mark.parametrize("kind", ["rooms", "maze"])
def test_native_bank_explicit_indices_and_shapes(kind):
    if kind == "rooms":
        ours = tfm.make_rooms_bank(indices=[0, 5, 2**32], width=24, height=24, max_rooms=4,
                                   backend="native", device="cpu")
        ref = jfm.make_rooms_bank(indices=[0, 5, 2**32], width=24, height=24, max_rooms=4,
                                  backend="native")
    else:
        ours = tfm.make_maze_bank(indices=[1, 9], width=15, height=11, branching_prob=0.5,
                                  backend="native", device="cpu")
        ref = jfm.make_maze_bank(indices=[1, 9], width=15, height=11, branching_prob=0.5,
                                 backend="native")
    _assert_bank_equal(ours, ref)


@pytest.mark.parametrize("kind", ["rooms", "maze"])
def test_auto_picks_native_as_apx_does(kind):
    mk_t = tfm.make_rooms_bank if kind == "rooms" else tfm.make_maze_bank
    mk_j = jfm.make_rooms_bank if kind == "rooms" else jfm.make_maze_bank
    ours = mk_t(num_maps=16, seed=4, backend="auto", device="cpu")
    _assert_bank_equal(ours, mk_j(num_maps=16, seed=4, backend="auto"))
    assert torch.equal(ours.maps, mk_t(num_maps=16, seed=4, backend="native", device="cpu").maps)


def test_native_unavailable(monkeypatch):
    monkeypatch.setattr(tnative, "_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native map generator unavailable"):
        tfm.make_rooms_bank(4, backend="native", device="cpu")
    auto = tfm.make_rooms_bank(4, backend="auto", device="cpu")
    _assert_bank_equal(auto, jfm.make_rooms_bank(4, backend="python"))
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.generate_rooms_bank_native([0])


@pytest.mark.parametrize("kind,seed", [("rooms", 11), ("maze", 12)])
def test_fetch_halves_bitwise(kind, seed):
    mk_t = tfm.make_rooms_bank if kind == "rooms" else tfm.make_maze_bank
    mk_j = jfm.make_rooms_bank if kind == "rooms" else jfm.make_maze_bank
    ours = mk_t(num_maps=5, seed=seed, device="cpu")
    ref = mk_j(num_maps=5, seed=seed, backend="python")
    rng = np.random.default_rng(seed)
    for idx in (np.arange(5), rng.integers(0, 5, 9), rng.integers(0, 5, (4, 3))):
        got = ours.fetch_halves(torch.from_numpy(idx))
        want = np.asarray(ref.fetch_halves(jnp.asarray(idx, dtype=jnp.int32)))
        assert got.dtype == torch.int32 and got.shape == (*idx.shape, ours.map_hw[0], 2)
        np.testing.assert_array_equal(got.numpy(), want)
        # The halves are the fetched rows' bits.
        bits = ((got[..., None] >> torch.arange(16, dtype=torch.int32)) & 1).flatten(-2)
        assert torch.equal(bits[..., :ours.map_hw[1]] == 1, ours.fetch(torch.from_numpy(idx)))
