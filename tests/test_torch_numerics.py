"""The exact-rounding helpers (``apx_torch.core.numerics``) on the CPU.

Their plain forms are what the CUDA kernels N1-N3
(``apx_torch/csrc/numerics.cu``) are held to bitwise on the card, so they
are held here to exact rational arithmetic (``fractions.Fraction``, rounded
to float32 by hand, half to even) on ``chip_smoke.numerics_cases``: ties,
sticky bits, subnormal results, signed zeros, overflow, inf and NaN, and
random values over wide exponents. On CPU tensors the helpers never build
or load the kernel library, and their values and gradients are those of the
forms the port had before the kernels (copied below as ``_old_*``).
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from apx_torch.core import numerics
from apx_torch.core.numerics import fma, sqrt, sum_squares
from apx_torch.ops import build
from apx_torch.ops._launch import launched
from chip_smoke import numerics_cases

torch.set_num_threads(1)

_HALF = Fraction(1, 2)


def round_f32(q: Fraction) -> float:
    """The float32 nearest the nonzero rational q, ties to even; +-inf past
    the overflow threshold; a signed zero below half the least subnormal."""
    neg, m = q < 0, abs(q)
    e = m.numerator.bit_length() - m.denominator.bit_length()
    if Fraction(2) ** e > m:
        e -= 1
    if Fraction(2) ** (e + 1) <= m:
        e += 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    units = m / ulp
    k = units.numerator // units.denominator
    rest = units - k
    if rest > _HALF or (rest == _HALF and k % 2 == 1):
        k += 1
    value = k * ulp
    r = math.inf if value >= 2**128 else float(value)
    return -r if neg else r


def exact_fma(a: float, b: float, c: float) -> float:
    """IEEE 754 fusedMultiplyAdd of float32 values, rounded to nearest even."""
    if any(math.isnan(x) for x in (a, b, c)):
        return math.nan
    if (math.isinf(a) and b == 0) or (math.isinf(b) and a == 0):
        return math.nan
    if math.isinf(a) or math.isinf(b):
        p = math.copysign(math.inf, a) * math.copysign(1.0, b)
        return math.nan if math.isinf(c) and c != p else p
    if math.isinf(c):
        return c
    p = Fraction(a) * Fraction(b)
    q = p + Fraction(c)
    if q == 0:  # an exact zero: -0 only for (-0) + (-0)
        p_neg = math.copysign(1.0, a) * math.copysign(1.0, b) < 0
        return -0.0 if p == 0 and p_neg and math.copysign(1.0, c) < 0 else 0.0
    return round_f32(q)


def exact_sqrt(x: float) -> float:
    """The correctly rounded float32 root of a float32 value."""
    if math.isnan(x) or x < 0:
        return math.nan
    if x == 0 or math.isinf(x):
        return x
    y, q = np.float32(math.sqrt(x)), Fraction(x)
    while True:  # no root of a float32 is a float32 midpoint: no ties
        lo = np.nextafter(y, np.float32(0))
        hi = np.nextafter(y, np.float32(np.inf))
        if ((Fraction(float(lo)) + Fraction(float(y))) / 2) ** 2 > q:
            y = lo
        elif ((Fraction(float(y)) + Fraction(float(hi))) / 2) ** 2 < q:
            y = hi
        else:
            return float(y)


def assert_bits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Bitwise equal, every NaN counted equal to any NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), f"{what}: NaN positions differ"
    bad = np.flatnonzero(got.view(np.int32)[~nan] != want.view(np.int32)[~nan])
    assert bad.size == 0, (f"{what}: {bad.size} differ, first {got[~nan][bad[:4]]} "
                           f"against {want[~nan][bad[:4]]}")


@pytest.fixture(scope="module")
def cases():
    return numerics_cases(0)


def test_plain_fma_is_the_correctly_rounded_fma(cases):
    a, b, c = cases["fma"]
    want = np.array([exact_fma(float(x), float(y), float(z)) for x, y, z in zip(a, b, c)],
                    dtype=np.float32)
    got = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert_bits(got, want, "fma")
    # The cases reach what they are built for.
    assert np.isinf(want).sum() >= 8 and np.isnan(want).sum() >= 6
    assert ((want != 0) & (np.abs(want) < 2.0**-126)).sum() >= 50
    assert (np.signbit(want) & (want == 0)).sum() >= 3 and ((want == 0) & ~np.signbit(want)).any()


def test_plain_sqrt_is_the_correctly_rounded_root(cases):
    x = cases["sqrt"]
    want = np.array([exact_sqrt(float(v)) for v in x], dtype=np.float32)
    assert_bits(sqrt(torch.from_numpy(x)).numpy(), want, "sqrt")


@pytest.mark.parametrize("width", [2, 3, 5])
def test_plain_sum_squares_is_the_contracted_chain(cases, width):
    """x0*x0 rounded once, then one correctly rounded FMA per element, in
    order: XLA-CPU's fused reduce."""
    rows = cases["sum_squares"][width]
    want = []
    for row in rows.astype(np.float64):
        acc = exact_fma(row[0], row[0], 0.0)  # RN(x0 * x0), +0 for a zero row
        for v in row[1:]:
            acc = exact_fma(v, v, acc)
        want.append(acc)
    assert_bits(sum_squares(torch.from_numpy(rows)).numpy(), np.array(want, np.float32),
                f"sum_squares K={width}")


# The helpers as the port had them before the kernels, for the CPU's values
# and gradients.
def _old_fma(a, b, c):
    if not isinstance(c, torch.Tensor):
        c = torch.full((), float(c), dtype=torch.float32, device=a.device)
    a, b, c = torch.broadcast_tensors(a, b, c)
    if a.requires_grad or b.requires_grad or c.requires_grad:
        return numerics._FMA.apply(a, b, c)
    return numerics._fma_f64(a, b, c)


def _old_sum_squares(x):
    acc = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = _old_fma(x[..., i], x[..., i], acc)
    return acc


def _old_sqrt(x):
    return torch.sqrt(x.double()).float()


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "load", refuse)
    before = [launched(k) for k in ("N1", "N2", "N3")]
    yield
    assert [launched(k) for k in ("N1", "N2", "N3")] == before  # the plain forms launch nothing


def test_cpu_tensors_run_the_plain_forms(no_build):
    """No build or load on CPU tensors; the values equal the old forms',
    with the call sites' operand shapes: (N, 2) against (N, 1) against a
    Python float, stride-2 slices, and Python floats for a or b."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4096, 2), generator=g) * 3
    col = torch.randn((4096, 1), generator=g)
    y = torch.randn(4096, generator=g)
    for args in ((x, col, 0.25), (x[:, 0], x[:, 1], y), (x, 2.0, -1.0), (x[:, 0], x[:, 0], 0.1),
                 (y, col[:, 0], x[:, 1]), (x, col, x[:1])):
        ref = next(v for v in args if isinstance(v, torch.Tensor))
        full = [v if isinstance(v, torch.Tensor) else torch.full_like(ref, v) for v in args]
        assert torch.equal(fma(*args).view(torch.int32), _old_fma(*full).view(torch.int32))
    assert torch.equal(fma(-1e-3, sum_squares(x), 0.1),
                       _old_fma(torch.full_like(y, -1e-3), _old_sum_squares(x), 0.1))
    wide = torch.randn((64, 8, 5), generator=g)
    for v in (x, wide, wide.transpose(0, 1), x[::2]):
        assert torch.equal(sum_squares(v), _old_sum_squares(v))
    for v in (y.abs(), x.abs()[:, 1], wide.abs()):
        assert torch.equal(sqrt(v), _old_sqrt(v))
    assert numerics.div(y, 7.0).equal(y / torch.full((), 7.0))
    with pytest.raises(TypeError):
        fma(1.0, 2.0, 3.0)


def _grads(fn, *xs):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    out.backward(torch.linspace(-1.5, 2.0, out.numel()).reshape(out.shape))
    return out.detach(), [x.grad for x in xs]


def test_gradients_equal_the_old_forms(no_build):
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn((256, 2), generator=g), torch.randn((256, 1), generator=g)
    c = torch.randn(256, generator=g)[:, None]
    pos = torch.rand(512, generator=g) * 5 + 1e-3
    cases = [
        (lambda p, q, r: fma(p, q, r), lambda p, q, r: _old_fma(p, q, r), (a, b, c)),
        (lambda p: fma(p, 0.5, -1.0), lambda p: _old_fma(p, torch.full_like(p, 0.5), -1.0),
         (a,)),
        (lambda p: fma(p, -0.25, p[:, :1]), lambda p: _old_fma(
            p, torch.full_like(p, -0.25), p[:, :1]), (a,)),
        (sum_squares, _old_sum_squares, (torch.randn((64, 5), generator=g),)),
        (sqrt, _old_sqrt, (pos,)),
        (numerics._Sqrt.apply, _old_sqrt, (pos,)),  # the card's form's backward
        (lambda p: sqrt(sum_squares(p)), lambda p: _old_sqrt(_old_sum_squares(p)), (a,)),
    ]
    for new, old, xs in cases:
        got, got_grads = _grads(new, *xs)
        want, want_grads = _grads(old, *xs)
        assert torch.equal(got, want)
        for gg, wg in zip(got_grads, want_grads):
            assert torch.equal(gg.view(torch.int32), wg.view(torch.int32))


def test_build_lists_the_numerics_kernels():
    assert any(s.name == "numerics.cu" and s.is_file() for s in build.SOURCES)
    for flag in ("-fmad=false", "-prec-sqrt=true", "-ftz=false"):
        assert flag in build.NVCC_FLAGS
    assert any("sm_90a" in f for f in build.NVCC_FLAGS)
    src = next(s for s in build.SOURCES if s.name == "numerics.cu").read_text()
    for name in ("fma_f32_launch", "sum_squares_f32_launch", "sqrt_f32_launch", "__fmaf_rn",
                 "__fsqrt_rn"):
        assert name in src
    assert "#include <torch" not in src  # a plain C interface, bound with ctypes


@pytest.mark.parametrize("make", [
    lambda t: t, lambda t: t[:, 1], lambda t: t[::2, ::3], lambda t: t.transpose(0, 2),
    lambda t: t[:, :1].expand(-1, 4, -1), lambda t: t[..., 0][:, None, :],
    lambda t: t.reshape(4, 5, 6, 7)[1:, :, ::2], lambda t: t[0, 0, 0].expand(3, 2),
    lambda t: t.reshape(2, 2, 5, 6, 7)[:, :, :, ::2, :3],
])
def test_merged_layout_reads_the_same_elements(make):
    """The layout the wrappers hand the kernels (sizes and strides after
    merging, at most 4 dimensions) walks a view's elements in row-major
    order: a strided read of the storage at those sizes and strides equals
    the view."""
    base = torch.arange(20 * 6 * 7, dtype=torch.float32).reshape(20, 6, 7)
    view = make(base)
    sizes, (strides,) = numerics._merged(view.shape, [view.stride()])
    assert 1 <= len(sizes) <= numerics.MAX_DIMS and math.prod(sizes) == view.numel()
    walked = torch.as_strided(base.reshape(-1), sizes, strides, view.storage_offset())
    assert torch.equal(walked.reshape(-1), view.reshape(-1))


def test_merged_layout_refuses_five_dimensions():
    base = torch.zeros(3, 4, 5, 6, 7)
    view = base[::2, ::2, ::2, ::2, ::2]  # no two dimensions merge
    with pytest.raises(ValueError, match="at most 4"):
        numerics._merged(view.shape, [view.stride()])
