"""apx_torch floor maps and map banks: bitwise equal to the JAX package's."""

import numpy as np
import pytest
import torch

from apx.data import floor_map as jfm

from apx_torch.convert import map_bank_from_numpy
from apx_torch.data import floor_map as tfm

torch.set_num_threads(1)


@pytest.mark.parametrize("idx", [0, 1, 7, 12345])
def test_maze_generator_bitwise(idx):
    np.testing.assert_array_equal(tfm.generate_maze_map(idx), jfm.generate_maze_map(idx))


@pytest.mark.parametrize("idx", [0, 1, 7, 999999])
def test_rooms_generator_bitwise(idx):
    np.testing.assert_array_equal(tfm.generate_rooms_map(idx), jfm.generate_rooms_map(idx))


def _assert_bank_equal(ours, ref):
    np.testing.assert_array_equal(ours.maps.numpy(), np.asarray(ref.maps))
    np.testing.assert_array_equal(ours.indices.numpy(), np.asarray(ref.indices).astype(np.int64))
    np.testing.assert_array_equal(ours.free_counts.numpy(), np.asarray(ref.free_counts))
    np.testing.assert_array_equal(ours.free_cells.numpy(), np.asarray(ref.free_cells))
    np.testing.assert_array_equal(ours.row_words.numpy(), np.asarray(ref.row_words).astype(np.int64))
    assert ours.kind == ref.kind and ours.map_hw == ref.map_hw


@pytest.mark.parametrize("kind,seed", [("maze", 0), ("rooms", 0), ("rooms", None), ("maze", 3)])
def test_bank_bitwise(kind, seed):
    mk_t = tfm.make_maze_bank if kind == "maze" else tfm.make_rooms_bank
    mk_j = jfm.make_maze_bank if kind == "maze" else jfm.make_rooms_bank
    ours = mk_t(num_maps=4, seed=seed, device="cpu")
    ref = mk_j(num_maps=4, seed=seed, backend="python")
    _assert_bank_equal(ours, ref)


@pytest.mark.parametrize("kind", ["maze", "rooms"])
def test_fetch_bitwise(kind):
    ours = (tfm.make_maze_bank if kind == "maze" else tfm.make_rooms_bank)(4, device="cpu")
    ref = (jfm.make_maze_bank if kind == "maze" else jfm.make_rooms_bank)(4, backend="python")
    idx = np.array([[3, 0, 1], [2, 2, 3]], dtype=np.int32)
    got = ours.fetch(torch.from_numpy(idx).long())
    assert got.shape == (2, 3, *ours.map_hw) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.fetch(idx)))


def test_explicit_indices_and_static_bank():
    ours = tfm.make_rooms_bank(num_maps=1, indices=[0], device="cpu")
    ref = jfm.make_rooms_bank(num_maps=1, indices=[0], backend="python")
    _assert_bank_equal(ours, ref)
    with pytest.raises(ValueError, match="unknown backend"):
        tfm.make_rooms_bank(2, backend="bogus", device="cpu")
    with pytest.raises(ValueError):
        tfm.make_rooms_bank(2, width=32, height=30, device="cpu")


@pytest.mark.parametrize("kind", ["maze", "rooms"])
def test_map_bank_from_numpy_round_trip(kind):
    ref = (jfm.make_maze_bank if kind == "maze" else jfm.make_rooms_bank)(4, backend="python")
    ours = map_bank_from_numpy(
        np.asarray(ref.maps), np.asarray(ref.indices), np.asarray(ref.free_counts),
        np.asarray(ref.free_cells), device="cpu", kind=ref.kind,
    )
    _assert_bank_equal(ours, ref)
    native = (tfm.make_maze_bank if kind == "maze" else tfm.make_rooms_bank)(4, device="cpu")
    for f in ("maps", "indices", "free_counts", "free_cells", "row_words"):
        assert torch.equal(getattr(ours, f), getattr(native, f)), f
