"""Kernel L's wrapper (``apx_torch.ops.light_dark_cuda``) and the env's
choice of it, on the CPU: the operand checks that run before any launch,
the plain forms that CPU tensors take, the kernel's registration, and the
edge cases the card tests hold L to (``chip_smoke.light_dark_cases``).
L itself runs on the card only: ``tests/test_torch_cuda_kernels.py -k
light_dark``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import apx_torch
from apx_torch.envs import light_dark as ld
from apx_torch.ops import _launch, build, light_dark_cuda
from chip_smoke import light_dark_cases

N = 64


def _params():
    return ld.LightDarkEnv(device="cpu").default_params()


def _leaf(n=N):
    return torch.zeros((n, 2))


def _call(kernel, pos, action, noise):
    p = _params()
    if kernel == "step":
        return light_dark_cuda.step(pos, action, noise, p.light_pos, p.light_height_sq,
                                    p.move_scale, p.folded_noise_scale)
    return light_dark_cuda.reset(pos, noise, p.light_pos, p.light_height_sq, p.noise_scale)


BAD = {
    "pos (N, 3)": (torch.zeros((N, 3)), _leaf(), _leaf()),
    "pos (N,)": (torch.zeros(N), _leaf(), _leaf()),
    "noise of other N": (_leaf(), _leaf(), _leaf(N + 1)),
    "noise float64": (_leaf(), _leaf(), _leaf().double()),
    "pos int32": (_leaf().int(), _leaf(), _leaf()),
    "noise strided": (_leaf(), _leaf(), torch.zeros((N, 4))[:, ::2]),
    "pos transposed": (torch.zeros((2, N)).t(), _leaf(), _leaf()),
    "noise misaligned": (_leaf(), _leaf(), torch.zeros(2 * N + 1)[1:].view(N, 2)),
}
BAD_ACTION = {
    "action (N, 1)": (_leaf(), torch.zeros((N, 1)), _leaf()),
    "action float64": (_leaf(), _leaf().double(), _leaf()),
    "action strided": (_leaf(), torch.zeros((N, 2, 2))[:, :, 0], _leaf()),
}


@pytest.mark.parametrize("kernel", ["step", "reset"])
@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_raises_on_a_bad_leaf(kernel, case):
    """A leaf of another shape, dtype or layout raises before any launch
    (the checks run on any device)."""
    before = _launch.launched("L")
    with pytest.raises(ValueError, match=f"light_dark_{kernel}"):
        _call(kernel, *BAD[case])
    assert _launch.launched("L") == before


@pytest.mark.parametrize("case", list(BAD_ACTION))
def test_step_raises_on_a_bad_action(case):
    with pytest.raises(ValueError, match="light_dark_step: action"):
        _call("step", *BAD_ACTION[case])


@pytest.mark.parametrize("kernel", ["step", "reset"])
def test_wrapper_refuses_cpu_tensors(kernel):
    """Well-formed CPU leaves raise in the wrapper: it launches or raises,
    and the env takes the plain form on the CPU itself."""
    with pytest.raises(ValueError, match="expected one CUDA device"):
        _call(kernel, _leaf(), _leaf(), _leaf())


def test_cpu_takes_the_plain_form_with_no_launch():
    """On CPU tensors the env's step, its reset and ``observe`` are the
    plain forms, with no launch."""
    venv, p = apx_torch.make_vec("LightDark-v0", 2 * N, device="cpu")
    x = {k: torch.from_numpy(v) for k, v in light_dark_cases(1, 2 * N).items()}
    before = _launch.launched("L")
    env = venv.env.env  # under the TimeLimit
    r = env.step_env(ld.LightDarkState(pos=x["pos"]), x["action"], None, p,
                     {"noise": x["noise"]})
    want = ld.step_plain(x["pos"], x["action"], x["noise"], p)
    got = (r.state.pos, r.obs["noisy_position"], r.base_reward, r.terminated, r.truncated)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w)
    assert r.prediction_target is x["pos"]
    obs, state, _ = env.reset_from_draws({"pos": x["pos"], "noise": x["noise"]}, p)
    assert torch.equal(obs["noisy_position"].view(torch.int32), ld.noisy_position(
        x["pos"], x["noise"], p.folded_noise_scale, p).view(torch.int32))
    assert state.pos is x["pos"]
    assert _launch.launched("L") == before


def test_cpu_step_keeps_a_gradient():
    """The device alone chooses: on the CPU an action that asks for a
    gradient takes the plain form, which carries it back to the action
    (on the card L's wrapper raises for it instead)."""
    venv, p = apx_torch.make_vec("LightDark-v0", N, device="cpu")
    g = torch.Generator().manual_seed(3)
    pos, noise = torch.rand((N, 2), generator=g) * 2 - 1, torch.randn((N, 2), generator=g)
    action = (torch.rand((N, 2), generator=g) - 0.5).requires_grad_(True)
    before = _launch.launched("L")
    r = venv.env.env.step_env(ld.LightDarkState(pos=pos), action, None, p, {"noise": noise})
    r.base_reward.sum().backward()
    assert torch.allclose(action.grad, -2e-3 * action.detach())
    assert _launch.launched("L") == before


def test_kernel_symbol_is_in_both_entries():
    """The benchmark's stage split finds a kernel span's node by
    ``KERNELS[id]`` in the traced kernel's name: both of L's device
    functions carry it, and the library builds L's source."""
    src = (Path(build.__file__).parent.parent / "csrc" / "light_dark.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(kThreads\)\n(\w+)\(", src)
    assert kernels == ["apx_light_dark_step", "apx_light_dark_reset"]
    assert all(_launch.KERNELS["L"] in k for k in kernels)
    assert any(s.name == "light_dark.cu" for s in build.SOURCES)


def test_light_dark_cases_reach_the_edges():
    """The card tests' cases hold what they claim: moves that land exactly
    on |p| = 1, just short of it and one ulp beyond; |a| exactly 1 and one
    ulp above; the light (no noise); observations clipped at +-2; NaN
    actions and observations."""
    p = _params()
    x = {k: torch.from_numpy(v) for k, v in light_dark_cases(2, 128).items()}
    moved = ld.moved_position(x["pos"], x["action"], p).abs().max(dim=-1).values
    one = torch.tensor(1.0)
    assert bool((moved == one).any())
    assert bool((moved == torch.nextafter(one, torch.tensor(2.0))).any())
    assert bool(((moved < one) & (moved > 1.0 - 3e-7)).any())
    mag = np.sqrt((x["action"].double() ** 2).sum(-1).numpy())
    assert (mag == 1.0).any() and ((mag > 1.0) & (mag < 1.0 + 2e-7)).any()
    obs = ld.noisy_position(x["pos"], x["noise"], p.folded_noise_scale, p)
    at_light = ((x["pos"] == torch.tensor(p.light_pos)).all(-1)
                & torch.isfinite(x["noise"]).all(-1) & (x["noise"] != 0).all(-1))
    assert bool(at_light.any()) and torch.equal(obs[at_light], x["pos"][at_light])
    assert bool((obs.abs() == 2.0).any())
    step_obs = ld.step_plain(x["pos"], x["action"], x["noise"], p)[1]
    assert bool(torch.isnan(x["action"]).any()) and bool(torch.isnan(step_obs).any())
