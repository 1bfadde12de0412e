"""apx_torch.data.stream: the iterators draw bitwise as apx's; the
prefetch thread's order, exception forwarding and close; BankRotator on
the CPU."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from apx.data import stream as jstream

from apx_torch.data import stream as tstream

torch.set_num_threads(1)


class _ListDataset:
    def __init__(self, items):
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        if isinstance(idx, np.ndarray):
            return [self.items[int(i)] for i in idx]
        return self.items[idx]


_DS = _ListDataset(range(1000, 1100))


@pytest.mark.parametrize("restrict", [None, [3, 7, 7, 50, 99]])
@pytest.mark.parametrize("seed", [0, 5])
def test_dataset_iterator_matches_apx(seed, restrict):
    ours = tstream.DatasetIterator(_DS, seed=seed, restrict_indices_to=restrict)
    ref = jstream.DatasetIterator(_DS, seed=seed, restrict_indices_to=restrict)
    for _ in range(50):
        (item, idx), (ref_item, ref_idx) = next(ours), next(ref)
        assert idx == ref_idx and item == ref_item == _DS[int(idx)]
        assert restrict is None or idx in restrict


@pytest.mark.parametrize("restrict", [None, np.arange(10, 40, 3)])
@pytest.mark.parametrize("batch", [1, 7])
def test_dataset_batch_iterator_matches_apx(batch, restrict):
    ours = tstream.DatasetBatchIterator(_DS, batch_size=batch, seed=3, restrict_indices_to=restrict)
    ref = jstream.DatasetBatchIterator(_DS, batch_size=batch, seed=3, restrict_indices_to=restrict)
    for _ in range(20):
        (items, idx), (ref_items, ref_idx) = next(ours), next(ref)
        np.testing.assert_array_equal(idx, ref_idx)
        assert items == ref_items and len(items) == batch


def test_buffered_iterator_order_and_exception():
    def gen():
        yield from range(50)
        raise RuntimeError("stream over")

    buf = tstream.BufferedIterator(iter(gen()), buffer_size=3)
    assert [next(buf) for _ in range(50)] == list(range(50))
    with pytest.raises(RuntimeError, match="stream over"):
        next(buf)
    buf.close()


def test_buffered_iterator_close_stops_the_thread():
    def forever():
        i = 0
        while True:
            yield i
            i += 1

    buf = tstream.BufferedIterator(forever(), buffer_size=2)
    assert [next(buf) for _ in range(5)] == list(range(5))
    buf.close()
    buf._thread.join(timeout=5)
    assert not buf._thread.is_alive()


@pytest.mark.parametrize("prefetch", [True, False])
def test_data_loader_matches_apx(prefetch):
    ours = tstream.DataLoader(tstream.DatasetIterator(_DS, seed=9), prefetch=prefetch,
                              prefetch_buffer_size=4)
    ref = jstream.DataLoader(jstream.DatasetIterator(_DS, seed=9), prefetch=prefetch,
                             prefetch_buffer_size=4)
    assert [next(ours) for _ in range(30)] == [next(ref) for _ in range(30)]
    ours.close()
    ref.close()


def _slab(k: int) -> dict:
    rng = np.random.default_rng(k)
    return {"images": rng.integers(0, 256, (6, 4, 4, 3), dtype=np.uint8),
            "labels": (np.arange(6) + k).astype(np.int64),
            "extra": (rng.random(5).astype(np.float32), rng.random((2, 2)) < 0.5)}


def test_bank_rotator_slabs_in_order_bitwise():
    calls = []

    def loader():
        calls.append(len(calls))
        return _slab(len(calls) - 1)

    rot = tstream.BankRotator(loader, device="cpu")
    try:
        for k in range(4):
            got = rot.swap()
            want = _slab(k)
            assert set(got) == set(want)
            for a, b in ((got["images"], want["images"]), (got["labels"], want["labels"]),
                         *zip(got["extra"], want["extra"])):
                assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
                assert a.dtype == torch.from_numpy(b).dtype and a.shape == b.shape
                np.testing.assert_array_equal(a.numpy(), b)
            assert isinstance(got["extra"], tuple)
            assert rot.last_copy_events is None  # no device copy on the CPU
    finally:
        rot.close()


def test_bank_rotator_stages_at_most_one_bank():
    calls = []
    ready = threading.Event()

    def loader():
        calls.append(1)
        ready.set()
        return np.full(3, len(calls))

    rot = tstream.BankRotator(loader, device="cpu")
    try:
        assert ready.wait(5)
        time.sleep(0.5)
        assert len(calls) == 1  # the thread waits for swap() before the next slab
        np.testing.assert_array_equal(rot.swap().numpy(), [1, 1, 1])
        deadline = time.monotonic() + 5
        while len(calls) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.5)
        assert len(calls) == 2
    finally:
        rot.close()


def test_bank_rotator_copies_the_host_slab():
    arr = np.arange(8, dtype=np.int32)
    rot = tstream.BankRotator(lambda: arr, device="cpu")
    try:
        got = rot.swap()
        arr[:] = -1
        np.testing.assert_array_equal(got.numpy(), np.arange(8))
    finally:
        rot.close()


def test_bank_rotator_reraises_loader_exception():
    n = {"calls": 0}

    def loader():
        n["calls"] += 1
        if n["calls"] == 2:
            raise OSError("slab 2 unreadable")
        return np.zeros(2)

    rot = tstream.BankRotator(loader, device="cpu")
    try:
        rot.swap()
        with pytest.raises(OSError, match="slab 2 unreadable"):
            rot.swap()
    finally:
        rot.close()


def test_bank_rotator_cuda_without_card_raises():
    if torch.cuda.is_available():
        rot = tstream.BankRotator(lambda: np.zeros(2), device="cuda")
        assert rot.swap().device.type == "cuda"
        rot.close()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tstream.BankRotator(lambda: np.zeros(2))


def test_bank_rotator_stress_order_and_bound():
    """200 swaps with a short switch interval: slabs arrive in order, and
    slab k is loaded only after swap k - 1 has begun (one staged slab)."""
    state = {"loaded": 0, "started": 0, "worst": -1}
    lock = threading.Lock()

    def loader():
        with lock:
            state["worst"] = max(state["worst"], state["loaded"] - state["started"])
            state["loaded"] += 1
            return np.full(4, state["loaded"] - 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    rot = tstream.BankRotator(loader, device="cpu")
    try:
        for k in range(200):
            with lock:
                state["started"] += 1
            assert int(rot.swap()[0]) == k
    finally:
        rot.close()
        sys.setswitchinterval(old)
    assert state["worst"] <= 0
