"""K1-K4 on the card: the CUDA kernels against their plain PyTorch forms,
and the envs that run them against the CPU.

Marked ``cuda``; each test skips (inside the test, via the fixture) when
no CUDA device is present, as on the CPU-only test machines. On a GPU
machine without JAX (``tests/conftest.py`` imports it) and without
pytest-xdist (``pyproject.toml`` adds ``-n 4``):

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from apx_torch.data.floor_map import make_maze_bank, make_rooms_bank
from apx_torch.ops import glimpse_cuda, issue_rate_study, raycast_cuda, window_cuda
from apx_torch.ops._launch import clear_launches, launched
from apx_torch.ops.glimpse import extract_glimpse_batch
from apx_torch.ops.raycast import lidar_directions_np, pad_occupancy, raycast_grid, seg_length
from apx_torch.ops.window import clamp_starts, extract_windows, window_starts
from chip_smoke import EDGE_MAPS, EDGE_N, EDGE_RAYS, NUMERICS, ROW_KEYS, edge_casts, edge_maps

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
STEP_L, RESET_L = "L.light_dark_step_launch", "L.light_dark_reset_launch"


def _failing_launch(*args):
    return 98  # cudaErrorInvalidDeviceFunction


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _casts(bank, n, gen, dev, centres):
    bank_pos = torch.randint(0, bank.num_maps, (n,), generator=gen, device=dev)
    occ = bank.fetch(bank_pos)
    k = torch.randint(0, 2**62, (n,), generator=gen, device=dev) % bank.free_counts[bank_pos]
    flat = bank.free_cells[bank_pos, k]
    w = bank.map_hw[1]
    origin = torch.stack([flat % w, flat // w], -1).to(torch.float32) + 0.5
    if not centres:
        origin = origin + (torch.rand((n, 2), generator=gen, device=dev) - 0.5) * 0.9
    beams = torch.from_numpy(lidar_directions_np(8) * np.float32(5.0)).to(dev)
    rand = (torch.rand((n, 3, 2), generator=gen, device=dev) * 2 - 1) * 6
    axis = torch.eye(2, device=dev) * rand[:, :2]  # d == 0 on one axis
    targets = origin[:, None] + torch.cat([beams.expand(n, -1, -1), rand, axis], dim=1)
    return occ, origin, targets


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("kind,r", [("rooms", None), ("maze", None),
                                    *((k, r) for k in EDGE_MAPS for r in EDGE_RAYS)])
@pytest.mark.parametrize("centres", [False, True])
def test_kernel_bitwise_equal_to_plain(dev, kind, r, typed, centres):
    """r = None: the env's casts on bank maps (1000 envs, 13 segments);
    else ``chip_smoke.edge_casts`` with r segments on EDGE_N envs."""
    seed = int(typed) + 2 * int(centres)
    if r is None:
        bank = (make_rooms_bank if kind == "rooms" else make_maze_bank)(16, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        occ, origin, targets = _casts(bank, 1000, gen, dev, centres)
    else:
        rng = np.random.default_rng(seed + 4 * r)
        occ_np = edge_maps(kind, EDGE_N, rng)
        origin, targets = edge_casts(occ_np, r, rng, centres)
        occ, origin, targets = (torch.from_numpy(x).to(dev) for x in (occ_np, origin, targets))
    kernel = raycast_cuda.raycast_typed if typed else raycast_cuda.raycast_fast
    key = f"K1.{kernel.__name__}_launch"
    before = launched(key)
    got = kernel(occ, origin, targets)
    torch.cuda.synchronize()
    assert launched(key) == before + 1
    want = raycast_grid(occ, origin, targets, geos_typing=typed)[0]
    assert torch.equal(_bits(got), _bits(want))
    seg = seg_length(targets - origin[:, None]) * 0.5  # a caller's own lengths
    assert torch.equal(_bits(kernel(occ, origin, targets, seg)),
                       _bits(raycast_grid(occ, origin, targets, seg, geos_typing=typed)[0]))


def test_kernel_rejects_bad_input(dev):
    occ = torch.zeros((2, 40, 40), dtype=torch.bool, device=dev)
    origin = torch.zeros((2, 2), device=dev)
    with pytest.raises(ValueError):
        raycast_cuda.raycast_fast(occ, origin, torch.zeros((2, 1, 2), device=dev))
    with pytest.raises(TypeError):
        raycast_cuda.raycast_fast(occ[:, :8, :8].float(), origin, torch.zeros((2, 1, 2), device=dev))


def test_env_on_card_matches_cpu(dev):
    import apx_torch
    from apx_torch.core.env import tree_map

    n = 64
    runs = [apx_torch.make_vec("LIDARLocMaze-v0", n, device=d) for d in ("cpu", dev)]
    gen = torch.Generator().manual_seed(3)
    draws = runs[0][0].env.draw_reset(n, runs[0][1], gen)
    carry = [v.reset(p, draws={k: x.to(p.device) for k, x in draws.items()})[:2]
             for v, p in runs]
    for _ in range(110):
        act = torch.rand((n, 2), generator=gen) * 2 - 1
        draws = runs[0][0].env.draw_reset(n, runs[0][1], gen)
        outs = []
        for i, (v, p) in enumerate(runs):
            o, s, r, *_ = v.step(carry[i][1], {"action": act.to(p.device),
                                              "prediction": torch.zeros(n, 2, device=p.device)},
                                 p, reset_draws={k: x.to(p.device) for k, x in draws.items()})
            carry[i] = (o, s)
            leaves = []
            tree_map(lambda x: leaves.append(x.cpu()), (o, s, r))
            outs.append(leaves)
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def _same_bits(got, want):
    """Bitwise equal on the CPU, any NaN equal to any NaN."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    return got.shape == want.shape and torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def test_numerics_on_card(dev):
    """The exact-rounding helpers give the CPU's bits on the card: N1-N3
    (one launch each) on ``chip_smoke.numerics_cases`` and at the call
    sites' shapes and strides; ``div`` as before."""
    from apx_torch.core.numerics import div, fma, sqrt, sum_squares
    from chip_smoke import numerics_cases

    gen = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(100_000, generator=gen) for _ in range(3))
    for f in (lambda x, y, z: fma(x, y, z), lambda x, y, z: div(x, 5.0),
              lambda x, y, z: sqrt(x.abs()), lambda x, y, z: div(x, 255.0)):
        assert torch.equal(f(a, b, c), f(a.to(dev), b.to(dev), c.to(dev)).cpu())

    def held(name, fn, *args):
        before = launched(ROW_KEYS[name])
        got = fn(*(x.to(dev) if isinstance(x, torch.Tensor) else x for x in args))
        torch.cuda.synchronize()
        assert launched(ROW_KEYS[name]) == before + 1, name
        assert _same_bits(got, fn(*args)), name

    cases = numerics_cases(0)
    held("fma", fma, *map(torch.from_numpy, cases["fma"]))
    held("sqrt", sqrt, torch.from_numpy(cases["sqrt"]))
    for rows in cases["sum_squares"].values():
        held("sum_squares", sum_squares, torch.from_numpy(rows))
    x = torch.randn((4096, 2), generator=gen) * 3
    col = torch.randn((4096, 1), generator=gen)
    wide = torch.randn((512, 8, 2), generator=gen)
    for args in ((x, col, 0.25), (x[:, 0], x[:, 1], col[:, 0]), (x, 2.0, -1.0),
                 (-1e-3, x[:, 1], 0.1), (x[::2], col[::2], x[1::2]),
                 (wide, wide[:, :1], x[:512, None]), (x[:, 0], 1e-3, x[:, 0])):
        held("fma", fma, *args)
    for v in (x, x[::2], wide, wide.transpose(0, 1), torch.randn((64, 5), generator=gen)):
        held("sum_squares", sum_squares, v)
    for v in (x.abs(), x.abs()[:, 1], wide.abs().transpose(0, 2)):
        held("sqrt", sqrt, v)


def test_numerics_raise_on_card(dev):
    """float64 operands and operands on two devices raise; nothing is
    counted."""
    from apx_torch.core.numerics import fma, sqrt, sum_squares

    before = [launched(k) for k in NUMERICS]
    x = torch.rand((16, 2), device=dev)
    with pytest.raises(TypeError):
        fma(x.double(), x.double(), 1.0)
    with pytest.raises(TypeError):
        fma(x, x.double(), x)
    with pytest.raises(ValueError):
        fma(x, x.cpu(), 1.0)
    with pytest.raises(TypeError):
        sum_squares(x.double())
    with pytest.raises(TypeError):
        sqrt(x.double())
    with pytest.raises(ValueError):
        sum_squares(x[0, 0])
    assert [launched(k) for k in NUMERICS] == before


def test_numerics_in_cuda_graph(dev):
    """N1-N3 capture in a CUDA graph and replay on new inputs."""
    from apx_torch.core.numerics import fma, sqrt, sum_squares

    x = torch.rand((4096, 2), device=dev)
    col = torch.rand((4096, 1), device=dev)
    fma(x, col, 0.5), sum_squares(x), sqrt(x)  # the library loaded before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sqrt(fma(x, col, -0.25).abs()) + sum_squares(x)[:, None]
    for seed in range(3):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x.copy_(torch.rand((4096, 2), generator=gen, device=dev) * 4 - 2)
        col.copy_(torch.rand((4096, 1), generator=gen, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        xc, cc = x.cpu(), col.cpu()
        want = sqrt(fma(xc, cc, -0.25).abs()) + sum_squares(xc)[:, None]
        assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("kind", ["rooms", "maze", "window"])
def test_kernel_computes_its_own_lengths(dev, kind, typed):
    """K1 with no lengths (the kernel computes the contracted |d|) equals K1
    given ``seg_length``'s, bitwise, on ``_casts`` and in the window frame;
    the wrapper launches K1 alone."""
    from apx_torch.ops.window_cuda import extract_windows as cut

    bank = (make_maze_bank if kind == "maze" else make_rooms_bank)(16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7 + int(typed))
    for centres in (False, True):
        occ, origin, targets = _casts(bank, 1000, gen, dev, centres)
        if kind == "window":
            starts, base = window_starts(origin, 16, 16)
            occ = cut(occ, starts, 16).view(torch.bool)
            origin, targets = origin - base, targets - base[:, None]
        kernel = raycast_cuda.raycast_typed if typed else raycast_cuda.raycast_fast
        seg = seg_length(targets - origin[:, None])
        before = [launched(k) for k in NUMERICS]
        got = kernel(occ, origin, targets)
        torch.cuda.synchronize()
        assert [launched(k) for k in NUMERICS] == before  # no length computed before the launch
        assert torch.equal(_bits(got), _bits(kernel(occ, origin, targets, seg)))
        assert torch.equal(_bits(got), _bits(raycast_grid(occ, origin, targets,
                                                          geos_typing=typed)[0]))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,sensor,scale,n", [((28, 28, 1), (5, 5), 1.0, 1000),
                                                  ((64, 64, 3), (10, 10), 1.0, 1000),
                                                  ((33, 47, 3), (4, 7), 2.5, 1000),
                                                  ((28, 28, 1), (3, 6), 0.5, 4097),
                                                  ((64, 64, 3), (6, 12), 2.0, 1),
                                                  ((20, 40, 1), (7, 32), 0.5, 4097),
                                                  ((20, 30, 1), (7, 2), 2.0, 4097),
                                                  ((16, 16, 3), (4, 4), 0.5, 1),
                                                  ((64, 64, 3), (10, 10), 0.5, 4097),
                                                  ((28, 28, 1), (5, 5), 1.0, 4096),
                                                  ((32, 32, 3), (5, 5), 1.0, 4096)])
def test_glimpse_kernel_matches_plain(dev, shape, sensor, scale, n, dtype):
    """K3 within 1e-6 of its plain form (float32 rounding of a 4-term
    bilinear; TF32 off for the plain form's products), on square and
    non-square sensors, C = 1 and 3, sample rows of s1 * C below, at and
    above the warp's 32 lanes, and N = 1, 1000, 4097; and at the MNIST and
    CIFAR10 envs' geometries at N = 4096."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(shape[0])
    if dtype == torch.uint8:
        images = torch.randint(0, 256, (n, *shape), generator=gen, device=dev, dtype=torch.uint8)
    else:
        images = torch.rand((n, *shape), generator=gen, device=dev)
    pos = torch.rand((n, 2), generator=gen, device=dev) * 2 - 1
    edges = torch.tensor([[1, 1], [-1, -1], [1, -1], [-1, 1], [0, 1], [1, 0]], device=dev)
    pos[:6] = edges[:n]
    before = launched("K3")
    got = glimpse_cuda.glimpse(images, pos, sensor, scale)
    torch.cuda.synchronize()
    assert launched("K3") == before + 1
    want = extract_glimpse_batch(images, pos, sensor, scale)
    assert got.shape == want.shape and (got - want).abs().max().item() <= 1e-6
    cpu = extract_glimpse_batch(images.cpu(), pos.cpu(), sensor, scale)
    assert (got.cpu() - cpu).abs().max().item() <= 1e-6


def test_glimpse_uint8_conversion_on_card(dev):
    """K3 converts every uint8 value to i / 255 correctly rounded: a 1x1
    sensor on a 1x1 image returns the converted pixel itself."""
    images = torch.arange(256, dtype=torch.uint8, device=dev).reshape(256, 1, 1, 1)
    got = glimpse_cuda.glimpse(images, torch.zeros((256, 2), device=dev), (1, 1))
    table = torch.arange(256, dtype=torch.float32) / 255
    assert torch.equal(got.reshape(256).cpu(), table)


def test_glimpse_raises_on_cuda_without_fallback(dev, monkeypatch):
    """A failed launch raises; the wrapper never returns the plain form."""
    monkeypatch.setattr(glimpse_cuda._ENTRIES[torch.float32], "fn", _failing_launch)
    before = launched("K3")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        glimpse_cuda.glimpse(torch.rand((4, 8, 8, 1), device=dev), torch.zeros((4, 2), device=dev),
                             (3, 3))
    assert launched("K3") == before


def test_image_env_on_card_matches_cpu(dev):
    import apx_torch
    from apx_torch.core.env import tree_map

    n = 64
    runs = [apx_torch.make_vec("CircleSquareInverted-v0", n, device=d) for d in ("cpu", dev)]
    gen = torch.Generator().manual_seed(3)
    draws = runs[0][0].env.draw_reset(n, runs[0][1], gen)
    carry = [v.reset(p, draws={k: x.to(p.device) for k, x in draws.items()})[:2]
             for v, p in runs]
    for _ in range(40):
        act = torch.rand((n, 2), generator=gen) * 2 - 1
        logits = torch.randn((n, 2), generator=gen)
        draws = runs[0][0].env.draw_reset(n, runs[0][1], gen)
        outs = []
        for i, (v, p) in enumerate(runs):
            o, s, r, te, *_ = v.step(carry[i][1], {"action": act.to(p.device),
                                                  "prediction": logits.to(p.device)},
                                     p, reset_draws={k: x.to(p.device) for k, x in draws.items()})
            carry[i] = (o, s)
            outs.append((o, s, r, te))
        (oc, sc, rc, tc), (og, sg, rg, tg) = outs
        assert (og["glimpse"].cpu() - oc["glimpse"]).abs().max() <= 1e-6
        assert (rg.cpu() - rc).abs().max() <= 1e-6
        for k in ("glimpse_pos", "time_step", "inverted_label"):
            assert torch.equal(og[k].cpu(), oc[k]), k
        assert torch.equal(tg.cpu(), tc)
        a, b = [], []
        tree_map(lambda x: a.append(x), sc)
        tree_map(lambda x: b.append(x.cpu()), sg)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _window_casts(dev, n, gen):
    """n envs of the rooms bank: maps, positions on free cells (generic
    points, the map's corners and edges first), K2's window starts around
    them and the window bases."""
    bank = make_rooms_bank(16, device=dev)
    bank_pos = torch.randint(0, bank.num_maps, (n,), generator=gen, device=dev)
    occ = bank.fetch(bank_pos)
    k = torch.randint(0, 2**62, (n,), generator=gen, device=dev) % bank.free_counts[bank_pos]
    flat = bank.free_cells[bank_pos, k]
    centre = torch.stack([flat % 32, flat // 32], -1).to(torch.float32) + 0.5
    pos = centre + (torch.rand((n, 2), generator=gen, device=dev) - 0.5) * 0.9
    edges = torch.tensor([[0, 0], [32, 32], [0, 32], [32, 0], [16, 0], [0, 16], [31.99, 7.5]],
                         device=dev)
    pos[:len(edges)] = edges
    starts, base = window_starts(pos, 16, 16)
    return occ, starts, base, pos, centre


def _padded_gather(occ, starts, pad, win):
    """The window of ``pad_occupancy(occ, pad)`` cut by slicing the padded
    copy (what K2 read before it read the unpadded map)."""
    padded = pad_occupancy(occ, pad)
    x0, y0 = clamp_starts(starts.to(torch.int64), padded.shape[1], padded.shape[2], win)
    return torch.stack([padded[i, y:y + 24, x:x + win] for i, (x, y) in
                        enumerate(zip(x0.tolist(), y0.tolist()))]).to(torch.uint8)


@pytest.mark.parametrize("kind,hw,pad,win", [
    ("rooms", (32, 32), 16, 16), ("rooms, byte offset", (32, 32), 16, 16),
    ("maze", (21, 21), 16, 16), ("random", (20, 36), 8, 16), ("random", (20, 36), 8, 4),
    ("random", (7, 5), 9, 13), ("random", (40, 64), 0, 48)])
def test_window_kernel_bitwise_equal_to_plain(dev, kind, hw, pad, win):
    """K2 on unpadded maps against the plain form on the card and on the CPU
    and against slicing the padded copy: the env path's starts, then
    out-of-range ones (negative, past the end) drawn in [-Hp - 4, Hp + 4] x
    [-Wp - 4, Wp + 4]. win 16, 4 and 13 take the kernel's 16-byte, 4-byte
    and 1-byte stores. The maze's 21 columns, and rooms maps that start one
    byte past a word, take its byte loads; the others its word loads."""
    h, w = hw
    hp, wp = h + 2 * pad, w + 2 * pad
    gen = torch.Generator(device=dev).manual_seed(11 + h + pad + win)
    n = 2000
    if kind == "random":
        occ = torch.rand((n, h, w), generator=gen, device=dev) < 0.4
    else:
        bank = (make_maze_bank if kind == "maze" else make_rooms_bank)(16, device=dev)
        occ = bank.fetch(torch.randint(0, bank.num_maps, (n,), generator=gen, device=dev))
    if kind == "rooms, byte offset":
        occ = torch.zeros(n * h * w + 1, dtype=torch.bool, device=dev)[1:].view(n, h, w).copy_(occ)
        assert occ.data_ptr() % 4 == 1
    pos = torch.rand((n, 2), generator=gen, device=dev) * torch.tensor([w, h], device=dev)
    starts, _ = window_starts(pos, 16, pad)
    lo = torch.tensor([-wp - 4, -hp - 4], device=dev)
    out_of_range = (torch.rand((n // 2, 2), generator=gen, device=dev)
                    * torch.tensor([2 * wp + 9, 2 * hp + 9], device=dev) + lo).floor()
    starts[n // 2:] = out_of_range.to(torch.int32)
    starts[-4:] = torch.tensor([[-wp - 4, -hp - 4], [wp + 4, hp + 4], [-1, -1], [wp, 0]],
                               dtype=torch.int32, device=dev)
    before = launched("K2")
    got = window_cuda.extract_windows(occ, starts, pad, win)
    torch.cuda.synchronize()
    assert launched("K2") == before + 1
    assert got.shape == (n, 24, win) and got.dtype == torch.uint8
    assert torch.equal(got, extract_windows(occ, starts, pad, win))
    assert torch.equal(got.cpu(), extract_windows(occ.cpu(), starts.cpu(), pad, win))
    assert torch.equal(got, _padded_gather(occ, starts, pad, win))


@pytest.mark.parametrize("typed", [False, True])
def test_kernel_on_windows_bitwise_equal_to_plain(dev, typed):
    """K1 on K2's (24, 16) windows in the window frame."""
    gen = torch.Generator(device=dev).manual_seed(12 + int(typed))
    occ, starts, base, pos, centre = _window_casts(dev, 1000, gen)
    origin = centre if typed else pos
    starts, base = window_starts(origin, 16, 16)
    win = window_cuda.extract_windows(occ, starts, 16).view(torch.bool)
    beams = torch.from_numpy(lidar_directions_np(8) * np.float32(5.0)).to(dev)
    move = (torch.rand((1000, 1, 2), generator=gen, device=dev) * 2 - 1) * 0.7
    for offs in ([beams.expand(1000, -1, -1)] if typed else
                 [move, torch.eye(2, device=dev) * move, beams.expand(1000, -1, -1)]):
        o, t = origin - base, (origin[:, None] + offs) - base[:, None]
        kernel = raycast_cuda.raycast_typed if typed else raycast_cuda.raycast_fast
        got = kernel(win, o, t)
        want = raycast_grid(win, o, t, geos_typing=typed)[0]
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("iters", [1, 5, 7, 512])
@pytest.mark.parametrize("layout,rows", [("wide", 512), ("wide", 4095), ("narrow", 512),
                                         ("narrow", 511)])
def test_chain_kernel_bitwise_equal_to_plain(dev, layout, rows, iters):
    """K4 bitwise the plain chain: iteration counts below, at and past the
    unroll factor with and without a remainder, and odd row counts, where a
    thread's second element (wide) or a warp's second row (narrow) is
    missing."""
    gen = torch.Generator(device=dev).manual_seed(5 + rows + iters)
    lanes = issue_rate_study.LANES[layout]
    args = [torch.rand((rows, lanes), generator=gen, device=dev) for _ in range(5)]
    before = launched("K4")
    got = issue_rate_study.chain_cuda(*args, iters=iters, layout=layout)
    torch.cuda.synchronize()
    assert launched("K4") == before + 1
    assert torch.equal(_bits(got), _bits(issue_rate_study.chain_body(*args, iters)))
    if iters <= 7:
        cpu = issue_rate_study.chain_body(*(a.cpu() for a in args), iters)
        assert torch.equal(_bits(got.cpu()), _bits(cpu))


def test_window_env_on_card_matches_cpu(dev):
    import apx_torch
    from apx_torch.core.env import tree_map

    n = 64
    runs = [apx_torch.make_vec("LIDARLocMaze-v0", n, device=d, raycast_backend="pallas_window")
            for d in ("cpu", dev)]
    gen = torch.Generator().manual_seed(4)
    draws = runs[0][0].env.draw_reset(n, runs[0][1], gen)
    carry = [v.reset(p, draws={k: x.to(p.device) for k, x in draws.items()})[:2]
             for v, p in runs]
    before = launched("K2")
    for _ in range(110):
        act = torch.rand((n, 2), generator=gen) * 2 - 1
        draws = runs[0][0].env.draw_reset(n, runs[0][1], gen)
        outs = []
        for i, (v, p) in enumerate(runs):
            o, s, r, te, *_ = v.step(carry[i][1], {"action": act.to(p.device),
                                                  "prediction": torch.zeros(n, 2, device=p.device)},
                                     p, reset_draws={k: x.to(p.device) for k, x in draws.items()})
            carry[i] = (o, s)
            leaves = []
            tree_map(lambda x: leaves.append(x.cpu()), (o, s, r, te))
            outs.append(leaves)
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    assert launched("K2") == before + 2 * 110  # the step's and the reset's


def test_window_raises_on_cuda_without_fallback(dev, monkeypatch):
    monkeypatch.setattr(window_cuda._WINDOW, "fn", _failing_launch)
    before = launched("K2")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        window_cuda.extract_windows(torch.zeros((4, 32, 32), dtype=torch.bool, device=dev),
                                    torch.zeros((4, 2), dtype=torch.int32, device=dev), 16)
    assert launched("K2") == before


def test_chain_raises_on_cuda_without_fallback(dev, monkeypatch):
    monkeypatch.setattr(issue_rate_study._CHAIN, "fn", _failing_launch)
    before = launched("K4")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        issue_rate_study.chain_cuda(*[torch.zeros((8, 16), device=dev)] * 5, iters=2,
                                    layout="narrow")
    assert launched("K4") == before


def _card_and_cpu_steps(dev, env_id, n, steps, seed, metrics=False):
    """Yield each step's (CPU outputs, card outputs) of ``env_id`` from the
    same actions and the same step and reset draws, drawn on the CPU."""
    import apx_torch
    from apx_torch.core.env import tree_map

    runs = [apx_torch.make_vec(env_id, n, device=d, metrics=metrics) for d in ("cpu", dev)]
    env, p0 = runs[0][0].env, runs[0][1]
    gen = torch.Generator().manual_seed(seed)

    def to(tree, d):
        return tree_map(lambda x: x.to(d), tree)

    draws = env.draw_reset(n, p0, gen)
    carry = [v.reset(p, draws=to(draws, p.device))[1] for v, p in runs]
    for _ in range(steps):
        act = torch.rand((n, 2), generator=gen) * 2 - 1
        step_draws, reset_draws = env.draw_step(n, p0, gen), env.draw_reset(n, p0, gen)
        outs = []
        for i, (v, p) in enumerate(runs):
            out = v.step(carry[i], {"action": act.to(p.device), "prediction": act.to(p.device)}, p,
                         reset_draws=to(reset_draws, p.device), step_draws=to(step_draws, p.device))
            carry[i] = out[1]
            outs.append(out)
        yield outs


def test_light_dark_on_card_matches_cpu(dev):
    """LightDark-v0 with injected step draws: bitwise on the card."""
    from apx_torch.core.env import tree_map

    for cpu, card in _card_and_cpu_steps(dev, "LightDark-v0", 64, 110, 8):
        a, b = [], []
        tree_map(a.append, cpu[:5])
        tree_map(lambda x: b.append(x.cpu()), card[:5])
        for x, y in zip(a, b, strict=True):
            assert torch.equal(x, y)


def test_sparse_metrics_lidar_on_card_matches_cpu(dev):
    """LIDARLocMaze-sparse-v0 with metrics: obs, states, rewards, dones and
    the prediction info bitwise; the stats' ints, bools and NaN positions
    bitwise, their floats within 1e-6; S launched once per step."""
    from apx_torch.core.env import tree_map

    def bitwise(out):
        obs, s, *rest, info = out
        return obs, s.inner, s.count, s.prev_done, rest, info["prediction"]

    def stats(out):
        return out[1].buf, out[5]["stats"]

    before = launched("S")
    for cpu, card in _card_and_cpu_steps(dev, "LIDARLocMaze-sparse-v0", 64, 110, 9, metrics=True):
        a, b = [], []
        tree_map(a.append, bitwise(cpu))
        tree_map(lambda x: b.append(x.cpu()), bitwise(card))
        for x, y in zip(a, b, strict=True):
            assert torch.equal(x, y)
        a, b = [], []
        tree_map(a.append, stats(cpu))
        tree_map(lambda x: b.append(x.cpu()), stats(card))
        for x, y in zip(a, b, strict=True):
            if x.dtype == torch.float32:
                assert torch.equal(torch.isnan(x), torch.isnan(y))
                ok = ~torch.isnan(x)
                assert not ok.any() or (x[ok] - y[ok]).abs().max() <= 1e-6
            else:
                assert torch.equal(x, y)
    assert launched("S") == before + 110


def test_space_sample_lands_on_the_generators_card(dev):
    """``action_space(params).sample(g)`` with a CUDA generator lands on the
    card, for a bounded and an unbounded (logit) prediction space."""
    import apx_torch

    g = torch.Generator(device=dev).manual_seed(0)
    for env_id in ("LightDark-v0", "CircleSquare-sparse-v0"):
        venv, p = apx_torch.make_vec(env_id, 4, device=dev)
        act = venv.env.action_space(p).sample(g, (4,))
        assert act["action"].device.type == "cuda" and act["prediction"].device.type == "cuda"
        assert torch.isfinite(act["prediction"]).all()


def test_sampler_on_card_matches_cpu(dev):
    """The unique-target sweep on the card (cuBLAS, TF32 off) against the
    CPU's at TinyImageNet's geometry: scores within 3e-6 (the tolerance of
    tests/test_torch_image_localization.py against apx), and TF32 left as
    the caller set it."""
    from apx_torch.data.huggingface import synthetic_image_bank
    from apx_torch.envs.image_perception import ImagePerceptionEngine, ImagePerceptionParams

    bank = synthetic_image_bank("zh-plus/tiny-imagenet", num_points=64, device="cpu")
    p_cpu = ImagePerceptionParams(dataset=bank, sensor_size=(10, 10))
    card = synthetic_image_bank("zh-plus/tiny-imagenet", num_points=64, device=dev)
    p_dev = ImagePerceptionParams(dataset=card, sensor_size=(10, 10))
    torch.backends.cuda.matmul.allow_tf32 = True
    u_dev = ImagePerceptionEngine.uniqueness(card.images, p_dev)
    assert torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    u_cpu = ImagePerceptionEngine.uniqueness(bank.images, p_cpu)
    assert (u_dev.cpu() - u_cpu).abs().max().item() <= 3e-6


def test_new_envs_on_card_match_cpu(dev):
    """DoubleCircleSquare's synthesis bitwise, and HideAndSeek and
    TinyImageNetLoc (from the CPU's reset state, so the sampler's ties do
    not enter) stepped on the card and the CPU: ints, bools and targets
    bitwise, glimpses and rewards within 1e-6."""
    import apx_torch
    from apx_torch.core.env import tree_map

    idx = torch.randint(0, 900_000, (4096,), generator=torch.Generator().manual_seed(0))
    dcs = {d: apx_torch.make("DoubleCircleSquare-v0", device=d)[1].dataset for d in ("cpu", dev)}
    assert torch.equal(dcs["cpu"].fetch_raw(idx)[0], dcs[dev].fetch_raw(idx.to(dev))[0].cpu())
    for env_id in ("CircleSquareHideAndSeek-v0", "TinyImageNetLoc-v0"):
        runs = {d: apx_torch.make_vec(env_id, 64, device=d) for d in ("cpu", dev)}
        g = torch.Generator().manual_seed(1)
        obs, s_cpu, _ = runs["cpu"][0].reset(runs["cpu"][1], g)
        s_dev = tree_map(lambda x: x.to(dev), s_cpu)
        for t in range(34):
            act = {"action": torch.rand((64, 2), generator=g) * 2 - 1,
                   "prediction": torch.randn((64, 2), generator=g)}
            draws = runs["cpu"][0].env.draw_reset(64, runs["cpu"][1], g)
            oc, s_cpu, rc, tc, *_ = runs["cpu"][0].step(s_cpu, act, runs["cpu"][1], reset_draws=draws)
            og, s_dev, rg, tg, *_ = runs[dev][0].step(s_dev, tree_map(lambda x: x.to(dev), act),
                                                     runs[dev][1],
                                                     reset_draws=tree_map(lambda x: x.to(dev), draws))
            assert torch.equal(tc, tg.cpu()) and (rc - rg.cpu()).abs().max() <= 1e-6
            for k in oc:
                if "glimpse" in k and k != "glimpse_pos":
                    assert (oc[k] - og[k].cpu()).abs().max() <= 1e-6, k
                else:
                    assert torch.equal(oc[k], og[k].cpu()), k


def test_bank_rotator_on_card(dev):
    """BankRotator stages pinned slabs on its own stream: each swap is its
    host slab bitwise, on the card, after the copy's event."""
    from apx_torch.data.stream import BankRotator

    slabs = [{"images": np.random.default_rng(k).integers(0, 256, (64, 8, 8, 3), dtype=np.uint8),
              "labels": np.arange(64, dtype=np.int64) + k} for k in range(3)]
    remaining = iter(slabs)
    rot = BankRotator(lambda: next(remaining), device=dev)
    try:
        for want in slabs:
            got = rot.swap()
            start, done = rot.last_copy_events
            assert start.elapsed_time(done) >= 0
            for k in want:
                assert got[k].device.type == "cuda"
                np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])
    finally:
        rot.close()


def test_checkpoint_card_to_cpu_and_back(dev, tmp_path):
    """A state saved on the card restores onto a CPU like and back, bitwise."""
    import apx_torch
    from apx_torch.utils.checkpoint import restore_state, save_state

    venv, params = apx_torch.make_vec("CircleSquare-v0", 64, device=dev, metrics=True)
    g = torch.Generator(dev).manual_seed(0)
    _, state, _ = venv.reset(params, g)
    act = {"action": torch.rand((64, 2), generator=g, device=dev) * 2 - 1,
           "prediction": torch.randn((64, 2), generator=g, device=dev)}
    for _ in range(5):
        _, state, *_ = venv.step(state, act, params, g)
    save_state(str(tmp_path / "s.pt"), state)
    cpu_venv, cpu_params = apx_torch.make_vec("CircleSquare-v0", 64, device="cpu", metrics=True)
    on_cpu = restore_state(str(tmp_path / "s.pt"), cpu_venv.reset(cpu_params, torch.Generator())[1])
    back = restore_state(str(tmp_path / "s.pt"), state)
    leaves = {}
    for name, tree in (("card", state), ("cpu", on_cpu), ("back", back)):
        out = []
        apx_torch.core.env.tree_map(out.append, tree)
        leaves[name] = out
    for a, b, c in zip(leaves["card"], leaves["cpu"], leaves["back"], strict=True):
        assert b.device.type == "cpu" and c.device == a.device
        bits = a.cpu().reshape(-1).view(torch.uint8)
        assert torch.equal(bits, b.reshape(-1).view(torch.uint8))
        assert torch.equal(bits, c.cpu().reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("make_bank", [make_rooms_bank, make_maze_bank])
def test_native_bank_and_fetch_halves_on_card(dev, make_bank):
    bank = make_bank(64, backend="native", device=dev)
    cpu = make_bank(64, backend="native", device="cpu")
    assert torch.equal(bank.maps.cpu(), cpu.maps)
    idx = torch.randint(0, 64, (1000, 3), generator=torch.Generator().manual_seed(0))
    got = bank.fetch_halves(idx.to(dev))
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), cpu.fetch_halves(idx))


# ---- K1 and K3 on the paths of apx's A/B surfaces -----------------------------

@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("form,radius", [("windowed", 8), ("windowed", 2), ("mxu", None)])
def test_kernel_on_backend_windows_bitwise_equal_to_plain(dev, form, radius, typed):
    """K1 on the windows of ``"windowed"`` ((2r + 2)^2: 18x18 for the
    scans, 6x6 for the moves) and of ``"mxu_window"`` (16x16), cut around
    the casts of ``_casts`` and of ``chip_smoke.edge_casts`` on rooms maps,
    in the window frame."""
    from apx_torch.ops.raycast import extract_window_mxu, windowed_window

    gen = torch.Generator(device=dev).manual_seed(20 + int(typed))
    occ, origin, targets = _casts(make_rooms_bank(16, device=dev), 1000, gen, dev, typed)
    rng = np.random.default_rng(21)
    occ_np = edge_maps("rooms", EDGE_N, rng)
    e_origin, e_targets = edge_casts(occ_np, 8, rng, typed)
    cases = [(occ, origin, targets),
             tuple(torch.from_numpy(x).to(dev) for x in (occ_np, e_origin, e_targets))]
    for occ, origin, targets in cases:
        if form == "windowed":
            if radius == 2:  # the moves: segments of at most one cell per axis
                targets = origin[:, None] + (targets - origin[:, None]).clamp(-1.0, 1.0)
            reach = (targets - origin[:, None]).abs().amax((1, 2)) <= radius - 1
            occ, origin, targets = occ[reach], origin[reach], targets[reach]
            win, base = windowed_window(occ, origin, radius, 8)
            assert win.shape[1:] == (2 * radius + 2, 2 * radius + 2)
        else:
            reach = (targets - origin[:, None]).abs().amax((1, 2)) <= 6
            occ, origin, targets = occ[reach], origin[reach], targets[reach]
            win, base = extract_window_mxu(occ, 8, origin)
            assert win.shape[1:] == (16, 16)
        o, t = origin - base, targets - base[:, None]
        kernel = raycast_cuda.raycast_typed if typed else raycast_cuda.raycast_fast
        got = kernel(win, o, t)
        assert torch.equal(_bits(got), _bits(raycast_grid(win, o, t, geos_typing=typed)[0]))
        assert got.shape[0] > 50


@pytest.mark.parametrize("backend", ["bitslab2d", "bitslab", "windowed", "hybrid", "mxu_window",
                                     "pallas", "xla"])
def test_backend_env_on_card_matches_cpu(dev, backend):
    """Each raycast backend's LIDARLocRooms-v0 trajectory on the card
    bitwise the CPU's, and K1, F1, S and R launched where the backend runs
    them (``chip_smoke.backend_launches``): R for every reset scan on the
    whole map (under ``"pallas"`` untyped), S for every step whose casts
    all are."""
    import apx_torch
    from apx_torch.core.env import tree_map
    from chip_smoke import backend_launches, launch_counts

    n = 64
    runs = [apx_torch.make_vec("LIDARLocRooms-v0", n, device=d, raycast_backend=backend)
            for d in ("cpu", dev)]
    gen = torch.Generator().manual_seed(4)
    draws = runs[0][0].env.draw_reset(n, runs[0][1], gen)
    clear_launches()
    carry = [v.reset(p, draws={k: x.to(p.device) for k, x in draws.items()})[:2]
             for v, p in runs]
    want = backend_launches(backend, 0)
    assert launch_counts(want) == want
    for _ in range(40):
        act = torch.rand((n, 2), generator=gen) * 2 - 1
        draws = runs[0][0].env.draw_reset(n, runs[0][1], gen)
        outs = []
        for i, (v, p) in enumerate(runs):
            o, s, r, *_ = v.step(carry[i][1], {"action": act.to(p.device),
                                              "prediction": torch.zeros(n, 2, device=p.device)},
                                 p, reset_draws={k: x.to(p.device) for k, x in draws.items()})
            carry[i] = (o, s)
            leaves = []
            tree_map(lambda x: leaves.append(x.cpu()), (o, s, r))
            outs.append(leaves)
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    want = backend_launches(backend, 40)
    assert launch_counts(want) == want


@pytest.mark.parametrize("shape,sensor", [((64, 64, 3), (10, 10)), ((28, 28, 1), (5, 5))])
def test_glimpse_index_matches_plain(dev, shape, sensor):
    """K3 with its index: the chunked sampler's inputs (27 glimpses per
    image) and a gather from a bank, within 1e-6 of the plain form and
    bitwise K3 on the images copied out."""
    gen = torch.Generator(device=dev).manual_seed(6)
    bank = torch.randint(0, 256, (300, *shape), generator=gen, device=dev, dtype=torch.uint8)
    for index in (torch.arange(64, device=dev).repeat_interleave(27),
                  torch.randint(0, 300, (4096,), generator=gen, device=dev)):
        pos = torch.rand((index.shape[0], 2), generator=gen, device=dev) * 2 - 1
        pos[:4] = torch.tensor([[1.0, 1.0], [-1.0, -1.0], [1.0, -1.0], [0.0, 0.0]], device=dev)
        before = launched("K3")
        got = glimpse_cuda.glimpse(bank, pos, sensor, index=index)
        assert launched("K3") == before + 1
        copied = glimpse_cuda.glimpse(bank[index], pos, sensor)
        assert torch.equal(_bits(got), _bits(copied))
        want = extract_glimpse_batch(bank[index], pos, sensor, precision="highest")
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("mode", ["packed", "flat", "gather", "rows"])
def test_image_storage_on_card_bitwise_array(dev, mode):
    """TinyImageNetLoc-v0 at N=64 on the card under each storage mode
    bitwise the "array" run on the card, from the same draws, K3 launched
    as under "array". Under the row window (plain PyTorch, no K3) the
    glimpses are bitwise the plain "off" form's and within 1e-6 of K3's,
    every other leaf bitwise."""
    import apx_torch
    from apx_torch.envs.image_perception import ImagePerceptionEngine as engine

    n = 64
    kw = {"glimpse_window": "rows"} if mode == "rows" else {"image_storage": mode}
    runs = [apx_torch.make_vec("TinyImageNetLoc-v0", n, device=dev, **k) for k in (kw, {})]
    g = torch.Generator(device=dev).manual_seed(2)
    draws = runs[1][0].env.draw_reset(n, runs[1][1], g)
    launches = []
    carry = []
    for v, p in runs:
        clear_launches()
        carry.append(v.reset(p, draws=draws)[:2])
        launches.append(launched("K3"))
    for _ in range(20):
        act = {"action": torch.rand((n, 2), generator=g, device=dev) * 2 - 1,
               "prediction": torch.zeros((n, 2), device=dev)}
        rd = runs[1][0].env.draw_reset(n, runs[1][1], g)
        outs = [v.step(c[1], act, p, reset_draws=rd) for c, (v, p) in zip(carry, runs)]
        carry = [o[:2] for o in outs]
        for k in outs[0][0]:
            a, b = outs[0][0][k], outs[1][0][k]
            if mode == "rows" and k == "glimpse":
                s = outs[0][1].inner.perception
                off = extract_glimpse_batch(engine.image_raw(s, runs[0][1]), s.pos, (10, 10))
                assert torch.equal(a, off) and (a - b).abs().max().item() <= 1e-6
            elif mode == "rows" and k == "target_glimpse":
                assert (a - b).abs().max().item() <= 1e-6
            else:
                assert torch.equal(a, b), k
        assert torch.equal(outs[0][2], outs[1][2])
    assert launches[1] == 2 and launches[0] == (0 if mode == "rows" else 2)


def test_samplers_on_card_match_cpu(dev):
    """The chunked (27 glimpses per K3 launch) and streamed samplers on the
    card against the CPU's at TinyImageNet's geometry: scores within 3e-6."""
    from apx_torch.data.huggingface import synthetic_image_bank
    from apx_torch.envs.image_perception import ImagePerceptionEngine, ImagePerceptionParams

    bank = synthetic_image_bank("zh-plus/tiny-imagenet", num_points=16, device="cpu")
    card = synthetic_image_bank("zh-plus/tiny-imagenet", num_points=16, device=dev)
    for backend in ("chunked", "streamed"):
        p_cpu = ImagePerceptionParams(dataset=bank, sensor_size=(10, 10),
                                      unique_sampling_backend=backend)
        p_dev = ImagePerceptionParams(dataset=card, sensor_size=(10, 10),
                                      unique_sampling_backend=backend)
        before = launched("K3")
        u_dev = ImagePerceptionEngine.uniqueness(card.images, p_dev)
        assert launched("K3") - before == (27 if backend == "chunked" else 0)
        u_cpu = ImagePerceptionEngine.uniqueness(bank.images, p_cpu)
        assert (u_dev.cpu() - u_cpu).abs().max().item() <= 3e-6, backend


# ---- F1 (ops.lidar_step_cuda) and F2 (ops.merge_cuda) ----------------------


@pytest.mark.parametrize("stage", ["a", "b", "c", "d"])
def test_lidar_step_stage_bitwise_on_card(dev, stage):
    """Each F1 stage against its plain stage on the card, bitwise with NaN
    as NaN, on ``chip_smoke.lidar_step_cases`` at N = 4096 (stage A with
    and without the unfused length, in the map and in a window frame); one
    launch per call."""
    import apx_torch
    from apx_torch.ops import lidar_step, lidar_step_cuda
    from chip_smoke import _bits_equal_any, lidar_step_cases, lidar_step_inputs
    from chip_smoke import lidar_step_stage_args

    _, params = apx_torch.make_vec("LIDARLocRooms-v0", 8, device=dev)
    x = lidar_step_inputs(lidar_step_cases(17, 4096), dev)
    kernel = getattr(lidar_step_cuda, f"stage_{stage}")
    for args in lidar_step_stage_args(x, params)[stage]:
        before = launched("F1")
        got = kernel(*args)
        want = getattr(lidar_step, f"stage_{stage}")(*args)
        torch.cuda.synchronize()
        assert launched("F1") == before + 1
        assert set(got) == set(want)
        for k in want:
            assert _bits_equal_any(got[k], want[k]), k


def test_lidar_step_raises_on_card(dev):
    """A wrong dtype, shape, layout or device raises, and so does an action
    that requires grad (F1 has no backward); nothing is launched."""
    from apx_torch.ops import lidar_step_cuda

    a = torch.rand((64, 2), device=dev)
    before = launched("F1")
    with pytest.raises(ValueError, match="detach"):
        lidar_step_cuda.stage_a(a.clone().requires_grad_(), a, True)
    with torch.no_grad():
        lidar_step_cuda.stage_a(a.clone().requires_grad_(), a, True)
    assert launched("F1") == before + 1
    before = launched("F1")
    with pytest.raises(ValueError):
        lidar_step_cuda.stage_a(a.double(), a, True)
    with pytest.raises(ValueError):
        lidar_step_cuda.stage_a(a, a[:32], True)
    with pytest.raises(ValueError):
        lidar_step_cuda.stage_a(a.t().contiguous().t(), a, True)
    with pytest.raises(ValueError):
        lidar_step_cuda.stage_a(a, a.cpu(), True)
    assert launched("F1") == before


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMaze-v0", "LightDark-v0"])
def test_merge_bitwise_on_card(dev, env_id):
    """F2 against the plain merge (``ops.merge``) on one step's operands,
    half the envs reset: every output bitwise (NaN as NaN), one launch;
    and the prediction gradient through the loss and the reward."""
    from apx_torch.ops import merge, merge_cuda
    from chip_smoke import _bits_equal_any, merge_inputs, merged_leaves

    args, kw = merge_inputs(dev, env_id, 4096, 18)
    before = launched("F2")
    got = merge_cuda.next_step(*args, **kw)
    want = merge.next_step(*args, **kw)
    torch.cuda.synchronize()
    assert launched("F2") == before + 1
    for i, (g, w) in enumerate(zip(merged_leaves(got), merged_leaves(want), strict=True)):
        assert _bits_equal_any(g, w), i
    args, kw = merge_inputs(dev, env_id, 4096, 19, grad=True)
    weights = torch.rand(4096, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    grads = []
    for fn in (merge_cuda.next_step, merge.next_step):
        m = fn(*args, **kw)
        grads.append(torch.autograd.grad((m.reward * weights).sum() + 0.5 * m.loss.sum(),
                                         args[6])[0])
    assert _same_bits(grads[0], grads[1])


def test_merge_dispatch_on_card(dev):
    """On the card F2 launches for an MSE loss only: a base reward that
    requires grad raises (detach the action); the ``-sparse`` weighted
    loss goes to the plain merge, with no F2 launch, and equals it."""
    import apx_torch
    from apx_torch.ops import merge, merge_cuda
    from chip_smoke import _bits_equal_any, merge_inputs, merged_leaves

    args, kw = merge_inputs(dev, "LightDark-v0", 256, 4)
    before = launched("F2")
    with pytest.raises(ValueError, match="detach"):
        merge_cuda.next_step(args[0], *args[1:3], args[3].clone().requires_grad_(), *args[4:],
                             **kw)
    venv, p = apx_torch.make_vec("LightDark-sparse-v0", 256, device=dev)
    sparse = venv.env.loss_fn(p)
    target = {"target": args[7], "weight": args[4].to(torch.float32)}  # weight: terminated
    got = merge_cuda.next_step(*args[:7], target, sparse, **kw)
    want = merge.next_step(*args[:7], target, sparse, **kw)
    assert launched("F2") == before
    for i, (g, w) in enumerate(zip(merged_leaves(got), merged_leaves(want), strict=True)):
        assert _bits_equal_any(g, w), i


def test_dense_lidar_step_launches(dev):
    """One dense LIDAR step (``chip_smoke.DENSE_STEP``): S 1, R 1,
    F2 1, no standalone K1 or F1 launch and no N1-N3."""
    import apx_torch
    from chip_smoke import DENSE_STEP, launch_counts

    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", 256, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, state, _ = venv.reset(p, gen)
    act = torch.rand((256, 2), generator=gen, device=dev) * 2 - 1
    torch.cuda.synchronize()
    clear_launches()
    venv.step(state, {"action": act, "prediction": torch.zeros((256, 2), device=dev)}, p, gen)
    assert launch_counts(DENSE_STEP) == DENSE_STEP


def test_fused_step_in_cuda_graph(dev):
    """A dense LIDAR step through F1 and F2 captured in a CUDA graph and
    replayed equals the eager steps bitwise."""
    import apx_torch
    from apx_torch.core.env import tree_map

    n = 256
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    obs, state, _ = venv.reset(p, gen)
    act = torch.rand((n, 2), generator=gen, device=dev) * 2 - 1
    pred = torch.zeros((n, 2), device=dev)
    draws = venv.env.draw_reset(n, p, gen)
    venv.step(state, {"action": act, "prediction": pred}, p, reset_draws=draws)  # warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = venv.step(state, {"action": act, "prediction": pred}, p, reset_draws=draws)
    graph.replay()
    want = venv.step(state, {"action": act, "prediction": pred}, p, reset_draws=draws)
    torch.cuda.synchronize()
    a, b = [], []
    tree_map(a.append, out)
    tree_map(b.append, want)
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)


# ---- S and R (ops.lidar_fused_cuda) ----------------------------------------


@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMaze-v0"])
def test_fused_step_and_reset_bitwise_on_card(dev, env_id):
    """S and R against their plain forms (``ops.lidar_fused``) at N = 4096
    on the 32x32 rooms and 21x21 maze banks, every output bitwise with NaN
    as NaN, one launch each (``chip_smoke.hold_fused`` on
    ``chip_smoke.fused_inputs``: edge actions and positions; R typed and
    untyped)."""
    from chip_smoke import fused_inputs, hold_fused

    x = fused_inputs(dev, env_id, 4096, 29)
    assert hold_fused("fused_step", x["step"], time_it=False)["held"] > 0
    for key in ("reset", "reset_untyped"):
        assert hold_fused("fused_reset", x[key], time_it=False)["held"] > 0


def test_fused_raises_on_card(dev):
    """S raises on an action that requires grad (it has no backward), and
    S and R on a wrong dtype, shape, layout or device; nothing launched."""
    from apx_torch.ops import lidar_fused_cuda
    from chip_smoke import fused_inputs

    x = fused_inputs(dev, "LIDARLocRooms-v0", 64, 3)
    step, reset = list(x["step"]), list(x["reset"])
    before = launched("S"), launched("R")
    with pytest.raises(ValueError, match="detach"):
        lidar_fused_cuda.step(step[0], step[1].clone().requires_grad_(), *step[2:])
    bad = [(1, step[1].double()), (2, step[2][:32]), (2, step[2].t().contiguous().t()),
           (4, step[4].cpu()), (0, step[0].to(torch.uint8))]
    for i, v in bad:
        with pytest.raises(ValueError):
            lidar_fused_cuda.step(*step[:i], v, *step[i + 1:])
    for i, v in [(0, reset[0].to(torch.int32)), (1, reset[1][:32]), (3, reset[3].cpu())]:
        with pytest.raises(ValueError):
            lidar_fused_cuda.reset(*reset[:i], v, *reset[i + 1:])
    with pytest.raises(ValueError):
        lidar_fused_cuda.reset(*reset[:2], 33, *reset[3:])
    assert (launched("S"), launched("R")) == before
    with torch.no_grad():
        lidar_fused_cuda.step(step[0], step[1].clone().requires_grad_(), *step[2:])
    assert launched("S") == before[0] + 1


# ---- R's mask, its reads of the bank and its counter ---------------------------


def _reset_operands(dev, env_id: str, n: int, seed: int):
    """(params, the reset's draws, R's scan operands but ``typed``) of a
    reset of ``env_id`` at N = n."""
    import apx_torch

    venv, p = apx_torch.make_vec(env_id, num_envs=n, device=dev)
    d = venv.env.draw_reset(n, p, torch.Generator(device=dev).manual_seed(seed))
    return p, d, (p.map_bank.map_hw[1], p.beam_offsets, p.lidar_range, p.inv_map_size)


def _reset_forms(p, d):
    """R's two forms on these draws, as (operands, keywords): reading the
    bank itself, and on ``MapBank.spawn``'s gathered words and cells."""
    bank = p.map_bank
    words, flat, _ = bank.spawn(d["bank_pos"], d["k"])
    return {"fetch": ((bank.row_words, bank.free_cells),
                      {"fetch": (d["bank_pos"], d["k"], bank.indices)}),
            "gathered": ((words, flat), {})}


@pytest.mark.parametrize("share", [1.0, 0.0, 0.01, 0.5], ids=["all", "none", "1%", "50%"])
@pytest.mark.parametrize("typed", [True, False], ids=["typed", "untyped"])
@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMaze-v0"])
def test_fused_reset_mask_on_card(dev, env_id, typed, share):
    """R given a mask computes the envs it selects bitwise as R unmasked
    and as the plain form given the mask (NaN as NaN), in both forms, one
    launch each; a masked launch adds exactly N asked and the mask's count
    computed to the device counter, an unmasked one nothing."""
    from apx_torch.core import trace
    from apx_torch.ops import lidar_fused, lidar_fused_cuda

    n = 4096
    p, d, scan = _reset_operands(dev, env_id, n, 41)
    gen = torch.Generator(device=dev).manual_seed(43)
    only = torch.rand(n, generator=gen, device=dev) < share
    counter = trace.reset_counter(dev)
    for form, (args, kw) in _reset_forms(p, d).items():
        start = counter.tolist()
        want = lidar_fused_cuda.reset(*args, *scan, typed, **kw)
        torch.cuda.synchronize()
        assert counter.tolist() == start, form
        launches = launched("R")
        got = lidar_fused_cuda.reset(*args, *scan, typed, only=only, **kw)
        torch.cuda.synchronize()
        assert launched("R") == launches + 1, form
        plain = lidar_fused.reset_plain(*args, *scan, typed, only=only, **kw)
        assert list(got) == list(want) == list(plain), form
        for key in want:
            g = got[key][only]
            for w in (want[key][only], plain[key][only]):
                assert (_same_bits(g, w) if g.is_floating_point() else torch.equal(g, w)), \
                    f"{form} {key}"
        added = [a - b for a, b in zip(counter.tolist(), start)]
        assert added == [n, int(only.sum())], form


@pytest.mark.parametrize("typed", [True, False], ids=["typed", "untyped"])
@pytest.mark.parametrize("env_id", ["LIDARLocRooms-v0", "LIDARLocMaze-v0",
                                    "LIDARLocRoomsStatic-v0"])
def test_fused_reset_reads_the_bank_on_card(dev, env_id, typed):
    """R reading the bank's rows, free cells and indices itself equals R on
    ``MapBank.spawn``'s gathered operands, every output bitwise, and its
    ``map_idx`` is spawn's; both equal the plain form (``reset_plain``'s
    own fetch)."""
    from apx_torch.ops import lidar_fused, lidar_fused_cuda

    n = 4096
    p, d, scan = _reset_operands(dev, env_id, n, 47)
    forms = _reset_forms(p, d)
    (args, kw), (g_args, _) = forms["fetch"], forms["gathered"]
    got = lidar_fused_cuda.reset(*args, *scan, typed, **kw)
    gathered = lidar_fused_cuda.reset(*g_args, *scan, typed)
    plain = lidar_fused.reset_plain(*args, *scan, typed, **kw)
    _, _, index = p.map_bank.spawn(d["bank_pos"], d["k"])
    torch.cuda.synchronize()
    assert list(got) == [*gathered, "map_idx"] == list(plain)
    assert torch.equal(got["map_idx"], index)
    for key, want in plain.items():
        for other in (got, gathered):
            if key in other:
                assert (_same_bits(other[key], want) if want.is_floating_point()
                        else torch.equal(other[key], want)), key


def test_fused_reset_raises_on_bad_mask_or_fetch(dev):
    """R raises on a mask of another dtype, length or device, and on
    fetch operands of the wrong rank, dtype or device; nothing launched
    and nothing counted."""
    from apx_torch.core import trace
    from apx_torch.ops import lidar_fused_cuda

    n = 64
    p, d, scan = _reset_operands(dev, "LIDARLocRooms-v0", n, 53)
    forms = _reset_forms(p, d)
    (args, kw), (g_args, _) = forms["fetch"], forms["gathered"]
    bank_pos, k, indices = kw["fetch"]
    only = torch.ones(n, dtype=torch.bool, device=dev)
    counter = trace.reset_counter(dev)
    start, launches = counter.tolist(), (launched("S"), launched("R"))
    bad = [(g_args, {"only": only.to(torch.uint8)}), (g_args, {"only": only[:32]}),
           (g_args, {"only": only.cpu()}), (args, {"only": only[:32], **kw}),
           (args, {"fetch": (bank_pos[:, None], k, indices)}),
           (args, {"fetch": (bank_pos.to(torch.int32), k, indices)}),
           (args, {"fetch": (bank_pos, k.cpu(), indices)}),
           ((args[0], args[1][:, 0]), kw)]
    for i, (a, kws) in enumerate(bad):
        with pytest.raises(ValueError):
            lidar_fused_cuda.reset(*a, *scan, True, **kws)
        assert (launched("S"), launched("R")) == launches, i
    torch.cuda.synchronize()
    assert counter.tolist() == start


@pytest.mark.parametrize("timing", ["staggered", "synchronised"])
def test_masked_next_step_graph_replays_like_eager_steps(dev, timing, monkeypatch):
    """A 16-step NEXT_STEP chunk of LIDARLocRooms-v0 that crosses resets,
    captured as a CUDA graph with R masked by ``prev_done`` and replayed,
    gives bitwise the obs, state and rewards of eager steps that reset
    every env (R unmasked); each replay adds 16 N asked and the envs that
    were done computed to R's counter. Staggered: the envs end their
    episodes on steps of their own; synchronised: all on one step."""
    import apx_torch
    from apx_torch.core import trace
    from apx_torch.core.env import tree_map
    from apx_torch.envs.lidar_localization import LIDARLocalizationEnv

    n, steps = 1024, 16
    venv, p = apx_torch.make_vec("LIDARLocRooms-v0", n, device=dev)
    g = torch.Generator(dev).manual_seed(9)
    _, state, _ = venv.reset(p, g)
    limit = venv.env.max_episode_steps
    t = torch.arange(n, dtype=state.inner.t.dtype, device=dev)
    t = (t * 7) % limit if timing == "staggered" else torch.full_like(t, limit - 5)
    state = type(state)(inner=type(state.inner)(inner=state.inner.inner, t=t),
                        prev_done=state.prev_done)
    draws = [venv.env.draw_reset(n, p, g) for _ in range(steps)]
    act = [{"action": torch.rand((n, 2), generator=g, device=dev) * 2 - 1,
            "prediction": torch.randn((n, 2), generator=g, device=dev)} for _ in range(steps)]

    def chunk(state, done=None):
        rewards = []
        for j in range(steps):
            if done is not None:
                done.append(int(state.prev_done.sum()))
            obs, state, reward, *_ = venv.step(state, act[j], p, reset_draws=draws[j],
                                               step_draws={})
            rewards.append(reward)
        return obs, state, rewards

    masked = LIDARLocalizationEnv.autoreset_from_draws
    with monkeypatch.context() as m:
        m.setattr(LIDARLocalizationEnv, "autoreset_from_draws",
                  lambda self, draws, old_state, params, only=None:
                  masked(self, draws, old_state, params))
        done = []
        want = chunk(state, done)
    assert 0 < sum(done) < steps * n
    if timing == "synchronised":
        assert sorted(set(done)) == [0, n]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chunk(state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chunk(state)
    counter = trace.reset_counter(dev)
    torch.cuda.synchronize()
    start = counter.tolist()
    graph.replay()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counter.tolist(), start)] == [steps * n, sum(done)]
    got_leaves, want_leaves = [], []
    tree_map(got_leaves.append, out)
    tree_map(want_leaves.append, want)
    for a, b in zip(got_leaves, want_leaves, strict=True):
        assert (_same_bits(a, b) if a.is_floating_point() else torch.equal(a, b))


def test_light_dark_chunk_graph_replays_like_eager_steps(dev):
    """A 16-step NEXT_STEP chunk of LightDark-v0 with its step and reset
    draws injected, captured as a CUDA graph and replayed, gives bitwise
    the obs, state, rewards and dones of the same steps issued eagerly.
    The envs' step counts are staggered, so that episodes end at the time
    limit on steps of their own and resets fall inside the chunk."""
    import apx_torch
    from apx_torch.core.env import tree_map

    n, steps = 4096, 16
    venv, p = apx_torch.make_vec("LightDark-v0", n, device=dev)
    g = torch.Generator(dev).manual_seed(13)
    _, state, _ = venv.reset(p, g)
    limit = venv.env.max_episode_steps
    t = (torch.arange(n, dtype=state.inner.t.dtype, device=dev) * 7) % limit
    state = type(state)(inner=type(state.inner)(inner=state.inner.inner, t=t),
                        prev_done=state.prev_done)
    resets = [venv.env.draw_reset(n, p, g) for _ in range(steps)]
    noises = [venv.env.draw_step(n, p, g) for _ in range(steps)]
    act = [{"action": torch.rand((n, 2), generator=g, device=dev) * 2.5 - 1.25,
            "prediction": torch.randn((n, 2), generator=g, device=dev)} for _ in range(steps)]

    def chunk(state, done=None):
        outs = []
        for j in range(steps):
            if done is not None:
                done.append(int(state.prev_done.sum()))
            obs, state, *rest, _ = venv.step(state, act[j], p, reset_draws=resets[j],
                                             step_draws=noises[j])
            outs.append(rest)
        return obs, state, outs

    done = []
    want = chunk(state, done)
    assert 0 < sum(done) < steps * n
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chunk(state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chunk(state)
    graph.replay()
    torch.cuda.synchronize()
    got_leaves, want_leaves = [], []
    tree_map(got_leaves.append, out)
    tree_map(want_leaves.append, want)
    for a, b in zip(got_leaves, want_leaves, strict=True):
        assert (_same_bits(a, b) if a.is_floating_point() else torch.equal(a, b))


@pytest.mark.parametrize("n", [16384, 1000])
def test_light_dark_kernel_bitwise_on_card(dev, n):
    """L's step and reset against their plain forms (``step_plain``,
    ``noisy_position``: N1-N3 and ATen on the card) on
    ``chip_smoke.light_dark_cases`` (zero, unit and NaN actions, moves
    onto |p| = 1, the light, noise past +-2, random rows), every output
    bitwise with NaN as NaN, one launch per call; the reset at the env's
    folded scale and at the drop-in's."""
    import apx_torch
    from apx_torch.envs import light_dark as ld
    from apx_torch.ops import light_dark_cuda
    from chip_smoke import light_dark_cases

    _, p = apx_torch.make_vec("LightDark-v0", n, device=dev)
    x = {k: torch.from_numpy(v).to(dev) for k, v in light_dark_cases(n, n).items()}
    pos, action, noise = x["pos"], x["action"], x["noise"]
    before = launched(STEP_L), launched(RESET_L)
    got = light_dark_cuda.step(pos, action, noise, p.light_pos, p.light_height_sq, p.move_scale,
                               p.folded_noise_scale)
    torch.cuda.synchronize()
    assert launched(STEP_L) == before[0] + 1
    want = ld.step_plain(pos, action, noise, p)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and (_same_bits(g, w) if g.is_floating_point()
                                       else torch.equal(g, w))
    assert not bool(got[4].any()) and bool(got[3].any()) and bool(torch.isnan(got[1]).any())
    for k, scale in enumerate((p.folded_noise_scale, p.noise_scale), start=1):
        obs = light_dark_cuda.reset(pos, noise, p.light_pos, p.light_height_sq, scale)
        torch.cuda.synchronize()
        assert launched(RESET_L) == before[1] + k
        assert _same_bits(obs, ld.noisy_position(pos, noise, scale, p))


def test_light_dark_env_raises_for_what_l_cannot_take(dev):
    """On the card the env's step takes L whatever its operands, as S's
    does: an action that asks for a gradient, or one of another dtype,
    raises in L's wrapper before any launch instead of taking the plain
    form."""
    import apx_torch
    from apx_torch.envs import light_dark as ld
    n = 256
    venv, p = apx_torch.make_vec("LightDark-v0", n, device=dev)
    env = venv.env.env  # under the TimeLimit
    state = ld.LightDarkState(pos=torch.zeros((n, 2), device=dev))
    draws = {"noise": torch.zeros((n, 2), device=dev)}
    before = launched(STEP_L), launched(RESET_L)
    with pytest.raises(ValueError, match="light_dark_step: an operand requires grad"):
        env.step_env(state, torch.zeros((n, 2), device=dev, requires_grad=True), None, p, draws)
    with pytest.raises(ValueError, match="light_dark_step: action must be"):
        env.step_env(state, torch.zeros((n, 2), device=dev, dtype=torch.float64), None, p, draws)
    assert (launched(STEP_L), launched(RESET_L)) == before
    with torch.no_grad():
        env.step_env(state, torch.zeros((n, 2), device=dev, requires_grad=True), None, p, draws)
    assert launched(STEP_L) == before[0] + 1


def test_light_dark_step_launches_on_card(dev):
    """A NEXT_STEP LightDark-v0 step on the card is L's step, L's reset
    and F2, one launch each, and no N1-N3; the drop-in's reset builder
    takes L's reset at its own noise scale."""
    import apx_torch
    from apx_torch.compat.builders import reset_from_draws

    n = 4096
    venv, p = apx_torch.make_vec("LightDark-v0", n, device=dev)
    g = torch.Generator(dev).manual_seed(3)
    _, state, _ = venv.reset(p, g)
    act = {"action": torch.rand((n, 2), generator=g, device=dev) * 2 - 1,
           "prediction": torch.zeros((n, 2), device=dev)}
    torch.cuda.synchronize()
    keys = (STEP_L, RESET_L, "F2", *NUMERICS)
    before = [launched(k) for k in keys]
    venv.step(state, act, p, g)
    torch.cuda.synchronize()
    assert [launched(k) - b for k, b in zip(keys, before)] == [1, 1, 1, 0, 0, 0]
    draws = {"pos": torch.rand((n, 2), generator=g, device=dev) * 2 - 1,
             "noise": torch.randn((n, 2), generator=g, device=dev)}
    k = launched(RESET_L)
    obs, _, _ = reset_from_draws(venv.env, draws, p)
    assert launched(RESET_L) == k + 1
    cpu_venv, cpu_p = apx_torch.make_vec("LightDark-v0", n, device="cpu")
    cpu_obs, _, _ = reset_from_draws(cpu_venv.env, {k: v.cpu() for k, v in draws.items()}, cpu_p)
    assert _same_bits(obs["noisy_position"], cpu_obs["noisy_position"])
