"""Kernel M's wrapper (``apx_torch.ops.image_move_cuda``) and the image
engine's choice of it: on the CPU, the operand checks that run before any
launch, the plain form that CPU tensors take, the kernel's registration
and the edge cases the card tests hold M to
(``chip_smoke.image_move_cases``); on the card (marked ``cuda``, skipped
without a device), M bitwise against its plain form, the engine raising
for what M cannot take, and an image step's launches:

    python -m pytest --noconftest -o addopts="" tests/test_torch_image_move_kernel.py -m cuda
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import apx_torch
from apx_torch.envs.image_perception import ImagePerceptionEngine as E
from apx_torch.ops import _launch, build, image_move_cuda
from benchmark.metrics import glimpse_roofline
from chip_smoke import (IMAGE_MOVE_PARAMS, image_move_cases, image_move_kernel,
                        image_move_params, image_move_plain)

N = 64
LIMIT = 16


def _leaf(n=N):
    return torch.zeros((n, 2))


def _time(n=N):
    return torch.zeros(n, dtype=torch.int32)


def _flags(n=N):
    return torch.zeros(n, dtype=torch.bool)


def _call(pos, action, time, label_inverted=None, step_limit=LIMIT):
    return image_move_cuda.move(pos, action, time, label_inverted, (0.2, 0.2), step_limit)


BAD = {
    "pos (N, 3)": (torch.zeros((N, 3)), _leaf(), _time()),
    "pos (N,)": (torch.zeros(N), _leaf(), _time()),
    "action of other N": (_leaf(), _leaf(N + 1), _time()),
    "action float64": (_leaf(), _leaf().double(), _time()),
    "action (N, 1)": (_leaf(), torch.zeros((N, 1)), _time()),
    "pos int32": (_leaf().int(), _leaf(), _time()),
    "action strided": (_leaf(), torch.zeros((N, 2, 2))[:, :, 0], _time()),
    "pos transposed": (torch.zeros((2, N)).t(), _leaf(), _time()),
    "action misaligned": (_leaf(), torch.zeros(2 * N + 1)[1:].view(N, 2), _time()),
    "time int64": (_leaf(), _leaf(), _time().long()),
    "time (N, 1)": (_leaf(), _leaf(), torch.zeros((N, 1), dtype=torch.int32)),
    "time of other N": (_leaf(), _leaf(), _time(N - 1)),
    "time strided": (_leaf(), _leaf(), torch.zeros(2 * N, dtype=torch.int32)[::2]),
    "label_inverted int32": (_leaf(), _leaf(), _time(), _time()),
    "label_inverted of other N": (_leaf(), _leaf(), _time(), _flags(N + 1)),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_raises_on_a_bad_leaf(case):
    """A leaf of another shape, dtype or layout raises before any launch
    (the checks run on any device)."""
    before = _launch.launched("M")
    with pytest.raises(ValueError, match="image_move: "):
        _call(*BAD[case])
    assert _launch.launched("M") == before


@pytest.mark.parametrize("inverted", [False, True])
def test_wrapper_refuses_cpu_tensors(inverted):
    """Well-formed CPU leaves raise in the wrapper: it launches or raises,
    and the engine takes the plain form on the CPU itself."""
    with pytest.raises(ValueError, match="expected one CUDA device"):
        _call(_leaf(), _leaf(), _time(), _flags() if inverted else None)


@pytest.mark.parametrize("limit", [2**31, -2**31 - 1])
def test_wrapper_refuses_a_step_limit_outside_int32(limit):
    with pytest.raises(ValueError, match="image_move: step_limit must be an int32"):
        _call(_leaf(), _leaf(), _time(), step_limit=limit)


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _same(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("env_id", ["CircleSquareInverted-v0", "MNISTLoc-v0"])
def test_cpu_takes_the_plain_form_with_no_launch(env_id):
    """On CPU tensors the image envs' step is the plain chain: the state,
    the observation but its glimpse, the base reward and the dones are
    ``move_plain``'s bitwise, the glimpse is taken at the moved position,
    and nothing is launched."""
    n = 2 * N
    venv, p = apx_torch.make_vec(env_id, n, device="cpu")
    g = torch.Generator().manual_seed(4)
    _, state, _ = venv.reset(p, g)
    inner = state.inner
    loc = hasattr(inner, "perception")  # a localization env's state wraps the engine's
    perception = inner.perception if loc else inner
    x = {k: torch.from_numpy(v) for k, v in
         image_move_cases(5, n, p.max_step_length, p.step_limit).items()}
    perception = dataclasses.replace(perception, pos=x["pos"].clamp(-1, 1).nan_to_num(0.0),
                                     time=x["time"], label_inverted=x["label_inverted"])
    inner = dataclasses.replace(inner, perception=perception) if loc else perception
    before = _launch.launched("M")
    r = venv.env.step_env(inner, x["action"], None, p)
    new, rest, reward, terminated, truncated = E.move_plain(perception, x["action"], p)
    got = r.state.perception if loc else r.state
    assert _same(got.pos, new.pos) and _same(got.time, new.time)
    assert list(r.obs) == ["glimpse", *rest, *(["target_glimpse"] if loc else [])]
    for k, v in rest.items():
        assert _same(r.obs[k], v), k
    assert _same(r.base_reward, reward) and _same(r.terminated, terminated)
    assert _same(r.truncated, truncated) and not bool(truncated.any())
    torch.testing.assert_close(r.obs["glimpse"], E.get_glimpse(new, new.pos, p), rtol=0, atol=0,
                               equal_nan=True)
    assert _launch.launched("M") == before


def test_cpu_step_keeps_a_gradient():
    """The device alone chooses: on the CPU an action that asks for a
    gradient takes the plain form, which carries it back to the action
    (on the card M's wrapper raises for it instead)."""
    venv, p = apx_torch.make_vec("CircleSquare-v0", N, device="cpu")
    _, state, _ = venv.reset(p, torch.Generator().manual_seed(3))
    action = (torch.rand((N, 2), generator=torch.Generator().manual_seed(5)) - 0.5)
    action.requires_grad_(True)
    before = _launch.launched("M")
    r = venv.env.step_env(state.inner, action, None, p)
    r.base_reward.sum().backward()
    a = action.detach()
    assert torch.allclose(action.grad, -1e-3 * a / a.norm(dim=-1, keepdim=True))
    assert _launch.launched("M") == before


def test_kernel_symbol_is_the_entrys_and_not_a_glimpse():
    """The benchmark's stage split finds a kernel span's node by
    ``KERNELS[id]`` in the traced kernel's name: M's one device function
    carries it, and ``glimpse_roofline``'s pattern, which counts K3's time,
    does not match it; the library builds M's source."""
    src = (Path(build.__file__).parent.parent / "csrc" / "image_move.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(kThreads\)\n(\w+)\(", src)
    assert kernels == [_launch.KERNELS["M"]] == ["apx_image_move"]
    assert not any(pat in kernels[0] for pat in glimpse_roofline.PATTERNS)
    assert any(s.name == "image_move.cu" for s in build.SOURCES)
    assert "image_move_launch" in src


@pytest.mark.parametrize("name", list(IMAGE_MOVE_PARAMS))
def test_image_move_cases_reach_the_edges(name):
    """The card tests' cases hold what they claim, by the plain form: moves
    that land exactly on |p| = 1 and just short of it (and beyond it,
    before the clip); actions on, just over and far over the unit
    sphere, NaN and inf; times that terminate and do not, the int32 wrap;
    inverted labels of 0, 1 and 2; NaN positions kept."""
    p = image_move_params("cpu", name)
    x = {k: torch.from_numpy(v) for k, v in
         image_move_cases(2, 256, p.max_step_length, p.step_limit).items()}
    pos, time, reward, terminated, truncated, time_step, inverted = image_move_plain(x, p)
    one = torch.tensor(1.0)
    moved = (p.max_step[None] * x["action"] + x["pos"]).abs()  # before the clip, rounded twice
    assert bool((pos.abs() == one).any())
    assert bool(((pos.abs() < one) & (pos.abs() > 1 - 3e-7)).any())
    assert bool((moved > one).any())
    mag = np.sqrt((x["action"].double() ** 2).sum(-1).numpy())
    assert (mag == 1.0).any() and ((mag > 1.0) & (mag < 1.0 + 2e-7)).any()
    assert np.isinf(mag).any() and np.isnan(mag).any()
    assert bool(torch.isnan(pos).any()) and bool(torch.isnan(reward).any())
    assert bool(terminated.any()) and not bool(terminated.all()) and not bool(truncated.any())
    assert int(time.min()) == np.iinfo(np.int32).min and bool((time == 0).any())
    assert bool((time == p.step_limit).any()) and bool(torch.isfinite(time_step).all())
    if p.randomly_invert_labels:
        assert set(inverted.tolist()) == {0, 1, 2}
    else:
        assert inverted is None


# ---- on the card ----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(IMAGE_MOVE_PARAMS))
@pytest.mark.parametrize("n", [1000, 4096, 16384])
def test_image_move_bitwise_on_card(dev, n, name):
    """M against its plain form (``ImagePerceptionEngine.move_plain``:
    N1-N3 and ATen on the card) on ``chip_smoke.image_move_cases`` (zero,
    unit, huge, inf and NaN actions, positions at and past +-1, moves onto
    |p| = 1, times at the limit and the int32 extremes, random rows),
    every output bitwise with NaN as NaN and of the plain form's dtype, one
    launch per call; under TinyImageNetLoc-v0's parameters and under
    unequal max steps, a step limit of 7 and inverted labels."""
    p = image_move_params(dev, name)
    x = {k: torch.from_numpy(v).to(dev) for k, v in
         image_move_cases(n, n, p.max_step_length, p.step_limit).items()}
    before = _launch.launched("M")
    got = image_move_kernel(x, p)
    torch.cuda.synchronize()
    assert _launch.launched("M") == before + 1
    want = image_move_plain(x, p)
    for g, w in zip(got, want, strict=True):
        if w is None:
            assert g is None
            continue
        nan = torch.isnan(w) if w.is_floating_point() else torch.zeros_like(w, dtype=torch.bool)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(torch.isnan(g) if g.is_floating_point() else nan, nan)
        assert torch.equal(_bits(g[~nan]), _bits(w[~nan]))
    assert bool(torch.isnan(got[0]).any()) and bool(got[3].any()) and not bool(got[4].any())


@pytest.mark.cuda
def test_image_env_raises_for_what_m_cannot_take(dev):
    """On the card the engine's step takes M whatever its operands, as L's
    does: an action that asks for a gradient, or one of another dtype,
    raises in M's wrapper before any launch instead of taking the plain
    form; under no_grad the same action launches M."""
    n = 256
    venv, p = apx_torch.make_vec("CircleSquare-v0", n, device=dev)
    _, state, _ = venv.reset(p, torch.Generator(dev).manual_seed(1))
    env = venv.env
    before = _launch.launched("M"), _launch.launched("K3")
    with pytest.raises(ValueError, match="image_move: an operand requires grad"):
        env.step_env(state.inner, torch.zeros((n, 2), device=dev, requires_grad=True), None, p)
    with pytest.raises(ValueError, match="image_move: action must be"):
        env.step_env(state.inner, torch.zeros((n, 2), device=dev, dtype=torch.float64), None, p)
    assert (_launch.launched("M"), _launch.launched("K3")) == before
    with torch.no_grad():
        env.step_env(state.inner, torch.zeros((n, 2), device=dev, requires_grad=True), None, p)
    assert _launch.launched("M") == before[0] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["CircleSquareInverted-v0", "TinyImageNetLoc-v0"])
def test_image_step_launches_on_card(dev, env_id):
    """A LOCKSTEP image step on the card launches M once for the env's
    move and observation, P once for its loss and reward, and no N2 or N3
    (its glimpse and the autoreset's are K3's); from the same state, action and draws its state (but the
    carried target glimpse), dones and observation (but the glimpses)
    equal the CPU's bitwise, its rewards within 1e-6."""
    from apx_torch.core.env import tree_map

    n = 1024
    (cpu_venv, cpu_p), (venv, p) = [apx_torch.make_vec(env_id, n, device=d)
                                    for d in ("cpu", dev)]
    g = torch.Generator().manual_seed(8)
    _, cpu_state, _ = cpu_venv.reset(cpu_p, draws=cpu_venv.env.draw_reset(n, cpu_p, g))
    act = {"action": torch.rand((n, 2), generator=g) * 2 - 1,
           "prediction": torch.zeros((n, cpu_venv.env.prediction_space(cpu_p).shape[-1]))}
    reset = cpu_venv.env.draw_reset(n, cpu_p, g)

    def to(tree):
        return tree_map(lambda x: x.to(dev), tree)

    state = to(cpu_state)
    torch.cuda.synchronize()
    keys = ("M", "N2", "N3", "P")
    before = [_launch.launched(k) for k in keys]
    got = venv.step(state, to(act), p, reset_draws=to(reset))
    torch.cuda.synchronize()
    assert [_launch.launched(k) - b for k, b in zip(keys, before)] == [1, 0, 0, 1]
    want = cpu_venv.step(cpu_state, act, cpu_p, reset_draws=reset)
    for k in want[0]:
        if not k.endswith("glimpse"):
            assert _same(got[0][k].cpu(), want[0][k]), k
    assert (got[2].cpu() - want[2]).abs().max() <= 1e-6
    inner = [got[1].inner, want[1].inner]
    if hasattr(inner[0], "target_glimpse"):
        inner = [dataclasses.replace(s, target_glimpse=None) for s in inner]
    a, b = [], []
    tree_map(a.append, (inner[0], got[1].prev_done, *got[3:5]))
    tree_map(b.append, (inner[1], want[1].prev_done, *want[3:5]))
    assert len(a) == len(b) and all(_same(x.cpu(), y) for x, y in zip(a, b))
