"""Kernel P's wrapper (``apx_torch.ops.loss_cuda``) and the vector env's
use of it: on the CPU, which losses and shapes select P and which keep the
chain, the plain form that CPU tensors take (today's chain, op for op),
the arguments a launch passes (through a stand-in for the library), the
kernel's registration and the edge cases the card tests hold P to
(``chip_smoke.cross_entropy_cases`` and ``mse_cases``); on the card
(marked ``cuda``, skipped without a device), P bitwise against the chain,
its gradient, its errors, and the vector steps' launches:

    python -m pytest --noconftest -o addopts="" tests/test_torch_loss_kernel.py -m cuda
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import apx_torch
from apx_torch.core.env import AutoResetMode, with_autoreset
from apx_torch.core.losses import (AffineLossFn, CrossEntropyLossFn, LambdaLossFn, MSELossFn,
                                   MSETerms, WeightedLossFn, ZeroLossFn)
from apx_torch.core.numerics import div, fma_plain, sum_squares_plain
from apx_torch.ops import _launch, build, loss_cuda
from benchmark.metrics import glimpse_roofline
from chip_smoke import cross_entropy_cases, loss_fns, mse_cases

N = 64
FNS = loss_fns()
CE, CE_NORM = FNS["cross_entropy"], FNS["cross_entropy_normalized"]
MSE_LOC, MSE_LIDAR = FNS["mse_localization"], FNS["mse_lidar"]
WEIGHTED = WeightedLossFn(inner=CE_NORM, average_weight=1 / 16)


def _f(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _label(n=N, dtype=torch.int64):
    return torch.zeros(n, dtype=dtype)


# (loss, prediction, target, what P computes: "cross_entropy", "mse" or None)
DISPATCH = {
    "CE, 200 classes, int64": (CE, _f(N, 200), _label(), "cross_entropy"),
    "normalized CE, 200 classes": (CE_NORM, _f(N, 200), _label(), "cross_entropy"),
    "CE, 10 classes": (CE, _f(N, 10), _label(), "cross_entropy"),
    "CE, int32 label": (CE, _f(N, 10), _label(dtype=torch.int32), None),
    "CE, 2 classes": (CE_NORM, _f(N, 2), _label(), "cross_entropy"),
    "CE, 1 class": (CE, _f(N, 1), _label(), "cross_entropy"),
    "CE, 1024 classes": (CE, _f(N, 1024), _label(), "cross_entropy"),
    "CE, 1025 classes": (CE, _f(N, 1025), _label(), None),
    "CE, float64 logits": (CE, _f(N, 200, dtype=torch.float64), _label(), None),
    "CE, 3-D logits": (CE, _f(N, 4, 200), _label(N * 4).view(N, 4), None),
    "CE, 1-D logits": (CE, _f(200), _label(1), None),
    "CE, (N, 1) label": (CE, _f(N, 200), _label().view(N, 1), None),
    "CE, label of other N": (CE, _f(N, 200), _label(N + 1), None),
    "CE, float label": (CE, _f(N, 200), _f(N), None),
    "CE, int16 label": (CE, _f(N, 200), _label(dtype=torch.int16), None),
    "CE, no envs": (CE, _f(0, 200), _label(0), None),
    "affine over affine CE": (AffineLossFn(inner=CE_NORM, scale=2.0), _f(N, 200), _label(),
                              None),
    "subclass of CE": (type("MyCE", (CrossEntropyLossFn,), {})(num_classes=200), _f(N, 200),
                       _label(), None),
    "weighted CE (sparse ids)": (WEIGHTED, _f(N, 200), {"target": _label(), "weight": _f(N)},
                                 None),
    "zero": (ZeroLossFn(), _f(N, 2), _f(N, 2), None),
    "lambda": (LambdaLossFn(fn=lambda p, t: (p - t).abs().sum(-1)), _f(N, 2), _f(N, 2), None),
    "localization MSE": (MSE_LOC, _f(N, 2), _f(N, 2), "mse"),
    "LIDAR MSE": (MSE_LIDAR, _f(N, 2), _f(N, 2), "mse"),
    "LightDark MSE": (FNS["mse_light_dark"], _f(N, 2), _f(N, 2), "mse"),
    "MSE, 8 features": (MSELossFn(), _f(N, 8), _f(N, 8), "mse"),
    "MSE, 9 features": (MSELossFn(), _f(N, 9), _f(N, 9), None),
    "rounded-squares MSE, 3 features": (MSELossFn(fused_sum=False), _f(N, 3), _f(N, 3), None),
    "MSE, target of other shape": (MSE_LIDAR, _f(N, 2), _f(N, 1), None),
    "MSE, float64": (MSE_LIDAR, _f(N, 2, dtype=torch.float64),
                     _f(N, 2, dtype=torch.float64), None),
    "CE over float targets": (CE, _f(N, 2), _f(N, 2), None),
    "MSE over labels": (MSE_LIDAR, _f(N, 2), _label(), None),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_kernel_terms_choose_p_or_the_chain(case):
    """``kernel_terms`` is a type and shape test: the cross-entropy, alone
    or normalized, over 2-D float32 logits of at most 1024 classes with an
    (N,) int64 label (the image envs'), and the MSE losses ``mse_terms``
    takes, go
    to P; every other loss, dtype or shape keeps the chain (None)."""
    loss_fn, prediction, target, want = DISPATCH[case]
    terms = loss_cuda.kernel_terms(loss_fn, prediction, target)
    kind = {loss_cuda.CrossEntropyTerms: "cross_entropy", MSETerms: "mse"}.get(type(terms))
    assert kind == want and (terms is None) == (want is None)


def test_cross_entropy_terms_round_the_affine_step_as_the_chain():
    """The normalized loss's scale and offset are its float32 values, as
    ``AffineLossFn.__call__`` rounds them; the plain loss has none."""
    terms = loss_cuda.kernel_terms(CE_NORM, _f(N, 200), _label())
    assert terms == loss_cuda.CrossEntropyTerms(
        200, True, float(np.float32(CE_NORM.scale)), float(np.float32(CE_NORM.offset)))
    assert terms.scale == float(np.float32(1 / np.log(200)))
    assert loss_cuda.kernel_terms(CE, _f(N, 10), _label()) == \
        loss_cuda.CrossEntropyTerms(10, False, 1.0, 0.0)


def _onehot_ce(p, t):
    logp = torch.log_softmax(p, dim=-1)
    onehot = torch.arange(p.shape[-1]) == t[..., None].to(torch.int64)
    return -torch.where(onehot, logp, 0.0).sum(dim=-1)


def _affine(loss, fn):
    return loss * float(np.float32(fn.scale)) + float(np.float32(fn.offset))


def _chain(name, base, p, t):
    """Today's chain, written out op for op."""
    if name == "cross_entropy":
        loss = _onehot_ce(p, t)
        return loss, base - loss
    if name == "cross_entropy_normalized":
        loss = _affine(_onehot_ce(p, t), CE_NORM)
        return loss, base - loss
    if name == "weighted":
        loss = _affine(_onehot_ce(p, t["target"]), CE_NORM) * t["weight"]
        return loss, base - loss
    d = p - t
    if name == "mse_localization":
        s = (d * d).sum(dim=-1)
        k = float(np.float32(0.5) * np.float32(MSE_LOC.scale))
        return _affine(div(s, 2), MSE_LOC), fma_plain(s, -k, base)
    loss = _affine(div(sum_squares_plain(d), 2), MSE_LIDAR)
    return loss, base - loss


def _operands(name, n=N, seed=3):
    if name.startswith("mse"):
        x = mse_cases(seed, n)
    else:
        x = cross_entropy_cases(seed, n, 200)
    x = {k: torch.from_numpy(v) for k, v in x.items()}
    if name == "weighted":
        x["target"] = {"target": x["target"].clamp(0, 199),
                       "weight": (torch.arange(n) % 3 == 0).float()}
    return x


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _same(a, b) -> bool:
    """Bitwise, any NaN equal to any NaN."""
    nan = torch.isnan(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(torch.isnan(a), nan) \
        and torch.equal(_bits(a[~nan]), _bits(b[~nan]))


@pytest.mark.parametrize("name", ["cross_entropy", "cross_entropy_normalized",
                                  "mse_localization", "mse_lidar", "weighted"])
def test_plain_is_todays_chain(name):
    """``plain`` is the chain the vector env ran before P, op for op: the
    cross-entropy's log-softmax and one-hot select-sum, the normalized
    loss's float32 scale and offset, the localization MSE's rounded squares
    and contracted reward (an FMA), LIDAR's FMA chain, the sparse ids'
    weight; bitwise on the card tests' edge cases."""
    fn = WEIGHTED if name == "weighted" else FNS[name]
    x = _operands(name)
    got = loss_cuda.plain(fn, x["base_reward"], x["prediction"], x["target"])
    want = _chain(name, x["base_reward"], x["prediction"], x["target"])
    assert all(_same(g, w) for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("name", ["cross_entropy_normalized", "mse_localization", "mse_lidar"])
def test_cpu_takes_the_plain_form_with_no_launch(name):
    """On CPU tensors ``loss_and_reward`` is ``plain``, and nothing is
    launched, whatever P would compute on the card."""
    x = _operands(name)
    before = _launch.launched("P")
    got = loss_cuda.loss_and_reward(FNS[name], x["base_reward"], x["prediction"], x["target"])
    want = loss_cuda.plain(FNS[name], x["base_reward"], x["prediction"], x["target"])
    assert all(_same(g, w) for g, w in zip(got, want, strict=True))
    assert _launch.launched("P") == before


@pytest.fixture
def stand_ins(monkeypatch):
    """P's two entries bound to stand-ins that check their argument count
    against the entry's C signature, record the arguments and write a loss
    of 1 and a reward of 2 through the output pointers; the launch table is
    restored after the test."""
    import ctypes

    monkeypatch.setattr(_launch, "_TABLE", dict(_launch._TABLE))
    monkeypatch.setattr(_launch, "stream", lambda dev: 0)
    calls = []

    def fake(which, argtypes, loss_at, reward_at, n_at):
        def fn(*args):
            assert len(args) == len(argtypes), (which, args)
            calls.append((which, args))
            n = args[n_at]
            for at, v in ((loss_at, 1.0), (reward_at, 2.0)):
                (ctypes.c_float * n).from_address(args[at])[:] = [v] * n
            return 0
        return fn

    for launch, which, at in ((loss_cuda._CROSS_ENTROPY, "cross_entropy", (3, 4, 5)),
                              (loss_cuda._MSE, "mse", (3, 4, 5))):
        monkeypatch.setattr(launch, "fn", fake(which, launch.argtypes, *at))
    return calls


@pytest.mark.parametrize("classes,shift", [(200, 0), (200, 1), (10, 0), (16, 3), (2, 0)])
def test_launch_passes_the_cross_entropy_operands(stand_ins, classes, shift):
    """A cross-entropy launch passes the logits (a view at any offset),
    labels and base reward in place, the classes and the normalized loss's
    float32 scale and offset; it returns the two rows the kernel wrote,
    and counts one launch."""
    flat = torch.randn(N * classes + 4)
    prediction = flat[shift:shift + N * classes].view(N, classes)
    target = torch.randint(0, classes, (N,))
    base = torch.randn(N)
    terms = loss_cuda.kernel_terms(CE_NORM, prediction, target)
    before = _launch.launched("P.loss_cross_entropy_launch")
    loss, reward = loss_cuda.launch(terms, CE_NORM, base, prediction, target)
    assert _launch.launched("P.loss_cross_entropy_launch") == before + 1
    ((which, args),) = stand_ins
    assert which == "cross_entropy"
    assert args[:3] == (prediction.data_ptr(), target.data_ptr(), base.data_ptr())
    assert args[3:5] == (loss.data_ptr(), reward.data_ptr())
    assert args[5:] == (N, classes, 1, terms.scale, terms.offset, 0)
    assert torch.equal(loss, torch.ones(N)) and torch.equal(reward, torch.full((N,), 2.0))


@pytest.mark.parametrize("name", ["mse_localization", "mse_lidar", "mse_light_dark"])
def test_launch_passes_the_mse_terms(stand_ins, name):
    """An MSE launch passes ``mse_terms``' constants as F2's does, and a
    strided target is copied to a contiguous one first."""
    prediction = torch.randn(N, 2)
    target = torch.randn(N, 4)[:, ::2]
    base = torch.randn(N)
    terms = loss_cuda.kernel_terms(FNS[name], prediction, target)
    loss_cuda.launch(terms, FNS[name], base, prediction, target)
    ((which, args),) = stand_ins
    assert which == "mse" and args[0] == prediction.data_ptr() and args[2] == base.data_ptr()
    assert args[1] != target.data_ptr()
    assert args[5:] == (N, 2, int(terms.fused_sum), 1, int(terms.contract), terms.scale,
                        terms.offset, terms.k, 0)


@pytest.mark.parametrize("case", ["base (N, 1)", "base float64", "base of other N",
                                  "target requires grad", "base requires grad"])
def test_launch_raises_for_what_p_cannot_take(stand_ins, case):
    """Where P is chosen, a base reward that is not (N,) float32, and a
    base reward or target that asks for a gradient, raise before any
    launch; nothing falls back."""
    prediction, target, base = torch.randn(N, 2), torch.randn(N, 2), torch.randn(N)
    if case == "base (N, 1)":
        base = base[:, None]
    elif case == "base float64":
        base = base.double()
    elif case == "base of other N":
        base = torch.randn(N + 1)
    elif case == "target requires grad":
        target.requires_grad_()
    else:
        base.requires_grad_()
    terms = loss_cuda.kernel_terms(MSE_LIDAR, prediction, target)
    with pytest.raises(ValueError, match="loss: "):
        loss_cuda.launch(terms, MSE_LIDAR, base, prediction, target)
    assert stand_ins == []


def test_launch_differentiates_the_chain(stand_ins):
    """A prediction that asks for a gradient goes through ``LossReward``:
    the values are the launch's, the gradient the chain's bitwise."""
    prediction = torch.randn(N, 200, requires_grad=True)
    target, base = torch.randint(0, 200, (N,)), torch.randn(N)
    terms = loss_cuda.kernel_terms(CE_NORM, prediction, target)
    loss, reward = loss_cuda.launch(terms, CE_NORM, base, prediction, target)
    assert torch.equal(loss.detach(), torch.ones(N))
    (got,) = torch.autograd.grad((loss * 3 + reward).sum(), prediction)
    p = prediction.detach().requires_grad_()
    want_loss, want_reward = loss_cuda.plain(CE_NORM, base, p, target)
    (want,) = torch.autograd.grad((want_loss * 3 + want_reward).sum(), p)
    assert torch.equal(got, want)


def test_kernel_symbols_share_the_entrys_stem():
    """The benchmark's stage split finds a kernel span's node by
    ``KERNELS[id]`` in the traced kernel's name: both of P's device
    functions carry the stem, ``glimpse_roofline``'s pattern does not
    match them, the library builds P's source, and F2 and P share the MSE
    arithmetic through one header."""
    csrc = Path(build.__file__).parent.parent / "csrc"
    src = (csrc / "loss.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(kThreads\)\s*(\w+)\(", src)
    assert kernels == ["apx_loss_cross_entropy", "apx_loss_mse"]
    assert all(k.startswith(_launch.KERNELS["P"]) for k in kernels)
    assert not any(pat in k for k in kernels for pat in glimpse_roofline.PATTERNS)
    assert not any(_launch.KERNELS["P"] in sym for kid, sym in _launch.KERNELS.items()
                   if kid != "P")
    assert any(s.name == "loss.cu" for s in build.SOURCES)
    assert any(h.name == "mse_terms.cuh" for h in build.HEADERS)
    for name in ("loss.cu", "merge.cu"):
        assert '#include "mse_terms.cuh"' in (csrc / name).read_text()
    assert "loss_cross_entropy_launch" in src and "loss_mse_launch" in src


@pytest.mark.parametrize("classes", [200, 10, 2])
def test_cross_entropy_cases_reach_the_edges(classes):
    """The card tests' cases hold what they claim, by the chain: labels out
    of range give a -0.0 loss and the base reward back; a NaN row with an
    in-range label, or NaN at the label, gives NaN; -inf at the label gives
    +inf; a huge logit at the label gives a loss of -0.0 (log-probability
    +0); every other row is finite."""
    x = {k: torch.from_numpy(v) for k, v in cross_entropy_cases(1, 256, classes).items()}
    loss, reward = loss_cuda.plain(CE, x["base_reward"], x["prediction"], x["target"])
    out = (x["target"] < 0) | (x["target"] >= classes)
    assert int(out.sum()) == 5
    assert bool((loss[out] == 0).all()) and bool(torch.signbit(loss[out]).all())
    kept = out & ~torch.isnan(x["base_reward"])
    assert torch.equal(reward[kept], x["base_reward"][kept])
    assert bool(torch.isnan(loss).any()) and bool(torch.isposinf(loss).any())
    assert bool(((loss == 0) & torch.signbit(loss) & ~out).any())
    assert bool(torch.isfinite(loss[16:]).all())


def test_mse_cases_reach_the_edges():
    """The MSE cases give a zero loss, NaN, +inf (overflowing squares) and
    finite losses; the base rewards include -0, inf and NaN."""
    x = {k: torch.from_numpy(v) for k, v in mse_cases(1, 256).items()}
    loss, _ = loss_cuda.plain(MSE_LOC, x["base_reward"], x["prediction"], x["target"])
    assert float(loss[0]) == 0.0 and bool(torch.isnan(loss).any())
    assert bool(torch.isposinf(loss).any()) and bool(torch.isfinite(loss[8:]).all())
    assert bool(torch.signbit(x["base_reward"][1])) and bool(torch.isnan(x["base_reward"]).any())


@pytest.mark.parametrize("mode", ["DISABLED", "LOCKSTEP", "boundary"])
def test_op_by_op_sites_call_loss_and_reward_in_the_loss_span(monkeypatch, mode):
    """The DISABLED and LOCKSTEP steps and ``boundary_reset_step`` compute
    the loss and the reward with one ``loss_and_reward`` call, inside
    ``vector.loss``, and return what it returns."""
    from apx_torch.core import trace

    seen = []
    real = loss_cuda.loss_and_reward

    def spy(*args):
        seen.append(list(trace._stack()))
        out = real(*args)
        seen.append(out)
        return out

    monkeypatch.setattr(loss_cuda, "loss_and_reward", spy)
    venv, p = apx_torch.make_vec("CircleSquare-v0", 8, device="cpu")
    venv = with_autoreset(venv, AutoResetMode.DISABLED if mode == "DISABLED"
                          else AutoResetMode.LOCKSTEP)
    g = torch.Generator().manual_seed(2)
    _, state, _ = venv.reset(p, g)
    act = {"action": torch.zeros(8, 2), "prediction": torch.randn(8, 2, generator=g)}
    with trace.timed():
        if mode == "boundary":
            out = venv.boundary_reset_step(state, act, p, g)
        else:
            out = venv.step(state, act, p, g)
    assert len(seen) == 2
    assert seen[0][-1] == "apx.vector.loss"
    assert out[2] is seen[1][1]


# ---- on the card ----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, x):
    return {k: torch.from_numpy(v).to(dev) for k, v in x.items()}


def _hold(dev, fn, x):
    """P against the chain on the CUDA tensors ``x``: one launch, the loss
    and the reward bitwise with NaN as NaN."""
    before = _launch.launched("P")
    got = loss_cuda.loss_and_reward(fn, x["base_reward"], x["prediction"], x["target"])
    torch.cuda.synchronize()
    assert _launch.launched("P") == before + 1
    want = loss_cuda.plain(fn, x["base_reward"], x["prediction"], x["target"])
    for g, w in zip(got, want, strict=True):
        assert _same(g.cpu(), w.cpu())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("scale", [1.0, 100.0])
@pytest.mark.parametrize("classes", [200, 10, 2])
@pytest.mark.parametrize("n", [1000, 4096, 16384])
def test_cross_entropy_bitwise_on_card(dev, n, classes, scale, normalized):
    """P's cross-entropy against the chain (``log_softmax``, the one-hot
    select-sum, the affine step, the reward) on
    ``chip_smoke.cross_entropy_cases``: labels out of range, -inf, NaN,
    +inf and huge logits, standard-normal logits and logits times 100."""
    x = _on(dev, cross_entropy_cases(n + classes, n, classes, scale))
    loss, _ = _hold(dev, CE_NORM if normalized else CE, x)
    assert bool(torch.isnan(loss).any()) and bool(torch.signbit(loss).any())


@pytest.mark.cuda
@pytest.mark.parametrize("classes,shift", [(200, 1), (1024, 0), (1000, 0), (33, 0), (16, 0),
                                           (12, 2), (1, 0)])
def test_cross_entropy_widths_and_layouts_on_card(dev, classes, shift):
    """Every width class: groups of 1 to 32 lanes and up to 32 elements a
    lane, a last warp that holds fewer rows than it could, logits starting
    ``shift`` floats past a 16-byte boundary."""
    n = 3001
    x = _on(dev, cross_entropy_cases(classes, n, classes))
    flat = torch.empty(n * classes + shift, device=dev)
    x["prediction"] = flat[shift:].view(n, classes).copy_(x["prediction"])
    _hold(dev, CE_NORM, x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mse_localization", "mse_lidar", "mse_light_dark"])
@pytest.mark.parametrize("n", [1000, 4096, 16384])
def test_mse_bitwise_on_card(dev, n, name):
    """P's MSE against the chain (N1 in the localization reward) on
    ``chip_smoke.mse_cases``: the localization ids' rounded squares and
    contracted reward, LIDAR's FMA chain, LightDark's rounded squares."""
    _hold(dev, FNS[name], _on(dev, mse_cases(n, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cross_entropy_normalized", "mse_localization"])
def test_gradient_through_p_is_the_chains_on_card(dev, name):
    """A prediction that asks for a gradient: P's values, and the chain's
    gradient of the loss and the reward, bitwise with NaN as NaN (the
    overflowing squares' rows)."""
    x = _on(dev, (mse_cases if name.startswith("mse") else
                  lambda s, n: cross_entropy_cases(s, n, 200))(5, 4096))
    fn = FNS[name]
    clean = torch.isfinite(x["prediction"]).all(-1) & torch.isfinite(x["base_reward"])
    if not name.startswith("mse"):
        clean &= (x["target"] >= 0) & (x["target"] < 200)
    x = {k: v[clean] for k, v in x.items()}
    p = x["prediction"].clone().requires_grad_()
    before = _launch.launched("P")
    loss, reward = loss_cuda.loss_and_reward(fn, x["base_reward"], p, x["target"])
    assert _launch.launched("P") == before + 1
    (got,) = torch.autograd.grad((loss * 3 + reward).sum(), p)
    q = x["prediction"].clone().requires_grad_()
    want_loss, want_reward = loss_cuda.plain(fn, x["base_reward"], q, x["target"])
    (want,) = torch.autograd.grad((want_loss * 3 + want_reward).sum(), q)
    assert _same(loss.detach(), want_loss.detach()) and _same(reward.detach(),
                                                              want_reward.detach())
    assert _same(got, want)


@pytest.mark.cuda
def test_p_raises_on_card(dev):
    """On the card a target that asks for a gradient raises before any
    launch, and a base reward of another device does too."""
    x = _on(dev, mse_cases(2, 256))
    before = _launch.launched("P")
    with pytest.raises(ValueError, match="loss: the base reward or the prediction target"):
        loss_cuda.loss_and_reward(MSE_LOC, x["base_reward"], x["prediction"],
                                  x["target"].requires_grad_())
    with pytest.raises(ValueError, match="loss: base_reward must be"):
        loss_cuda.loss_and_reward(MSE_LOC, x["base_reward"].cpu(), x["prediction"],
                                  x["target"].detach())
    assert _launch.launched("P") == before


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,entry", [("CircleSquare-v0", "P.loss_cross_entropy_launch"),
                                          ("TinyImageNetLoc-v0", "P.loss_mse_launch"),
                                          ("CircleSquare-sparse-v0", None)])
def test_vector_steps_launch_p_once_on_card(dev, env_id, entry):
    """Each DISABLED and LOCKSTEP step and each boundary step launches P
    once (the launch table's ``P.*``): the cross-entropy for a
    classification id, the MSE for a localization id; the ``-sparse`` ids'
    weighted loss keeps the chain and launches none. The loss equals the
    plain form's on the same operands, bitwise."""
    n = 512
    venv, p = apx_torch.make_vec(env_id, n, device=dev)
    g = torch.Generator(dev).manual_seed(3)
    _, state, _ = venv.reset(p, g)
    disabled = with_autoreset(venv, AutoResetMode.DISABLED)
    lockstep = with_autoreset(venv, AutoResetMode.LOCKSTEP)
    steps = []
    _launch.clear_launches()
    for step in (disabled.step, lockstep.step, lockstep.boundary_reset_step):
        act = {"action": torch.rand((n, 2), generator=g, device=dev) * 2 - 1,
               "prediction": torch.randn((n, 2), generator=g, device=dev)}
        _, state, reward, *_ = step(state, act, p, g)
        steps.append(reward)
    table = {k: v for k, v in _launch.launches().items() if k.startswith("P.") and v}
    assert table == ({} if entry is None else {entry: 3})
    assert all(bool(torch.isfinite(r).all()) for r in steps)
