"""apx_torch stands alone: it imports neither JAX nor the apx package (nor
``datasets`` when it is imported), and its entry points default to the GPU
with no fallback to the CPU. The compat adapter's core runs without
gymnasium and PIL, and its gymnasium entry points say which package they
need."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "apx_torch"

_SCRIPT = """
import sys, torch
import apx_torch
assert "datasets" not in sys.modules, "import apx_torch imported datasets"
torch.set_num_threads(1)
venv, p = apx_torch.make_vec("LIDARLocRooms-v0", 4, device="cpu")
g = torch.Generator().manual_seed(0)
obs, s, _ = venv.reset(p, g)
act = {"action": torch.rand((4, 2), generator=g), "prediction": torch.zeros(4, 2)}
for _ in range(3):
    obs, s, r, te, tr, _ = venv.step(s, act, p, g)
venv, p = apx_torch.make_vec("CircleSquare-v0", 4, device="cpu")
obs, s, _ = venv.reset(p, g)
act = {"action": torch.rand((4, 2), generator=g), "prediction": torch.zeros(4, 2)}
for _ in range(18):
    obs, s, r, te, tr, _ = venv.step(s, act, p, g)
venv, p = apx_torch.make_vec("LIDARLocRooms-v0", 8, device="cpu", raycast_backend="pallas_window")
obs, s, _ = venv.reset(p, g)
act = {"action": torch.rand((8, 2), generator=g), "prediction": torch.zeros(8, 2)}
for _ in range(3):
    obs, s, r, te, tr, _ = venv.step(s, act, p, g)
venv, p = apx_torch.make_vec("LightDark-v0", 4, device="cpu")
obs, s, _ = venv.reset(p, g)
for _ in range(3):
    obs, s, r, te, tr, _ = venv.step(s, venv.env.action_space(p).sample(g, (4,)), p, g)
venv, p = apx_torch.make_vec("LIDARLocRooms-sparse-v0", 4, device="cpu", metrics=True)
obs, s, _ = venv.reset(p, g)
for _ in range(3):
    obs, s, r, te, tr, info = venv.step(s, venv.env.action_space(p).sample(g, (4,)), p, g)
assert "stats" in info and set(info["prediction"]["target"]) == {"target", "weight"}
venv, p = apx_torch.make_vec("CircleSquareHideAndSeekNoPrediction-sparse-v0", 4, device="cpu")
obs, s, _ = venv.reset(p, g)
venv, p = apx_torch.make_vec("DoubleCircleSquare-s15-v0", 4, device="cpu")
obs, s, _ = venv.reset(p, g)
import apx_torch.bench, apx_torch.convert, apx_torch.compat.builders, apx_torch.ops.build
import apx_torch.ops.glimpse_cuda, apx_torch.ops.window_cuda, apx_torch.ops.issue_rate_study
import apx_torch.data.huggingface, apx_torch.envs.image_localization
import apx_torch.data.stream, apx_torch.data.native, apx_torch.utils.checkpoint
import apx_torch.core.checks, apx_torch.core.numerics, apx_torch.distrib, apx_torch.distrib.selftest
assert apx_torch.data.floor_map.make_rooms_bank(4, backend="native", device="cpu").num_maps == 4
assert "datasets" not in sys.modules, "a port module imported datasets"
import apx_torch.compat.stats, apx_torch.render
import apx_torch.compat.perception_module, apx_torch.compat.dataset_classes
import apx_torch.tools.parse_trace, apx_torch.ops.glimpse_study
import apx_torch.examples.train_ppo_lidar, apx_torch.examples.train_ppo_mesh
import apx_torch.examples.train_vtrace_mesh, apx_torch.examples.train_r2d2_mesh
import apx_torch.examples.rollout_functional, apx_torch.examples.gym_compat
import apx_torch.examples.grid_selftest, apx_torch.graft_entry, apx_torch.core.peaks
assert "examples" not in sys.modules, "a port module imported apx's examples"
assert "gymnasium" not in sys.modules and "PIL" not in sys.modules
assert "imageio" not in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "apx"))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_runs_without_jax_or_apx():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|apx|examples)(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_source_imports_no_jax_or_apx(path):
    """No module of the port imports JAX, apx or apx's ``examples`` (whose
    scripts import JAX)."""
    assert not _FORBIDDEN.findall((ROOT / path).read_text()), path


def test_forbidden_pattern_catches_apx_examples():
    assert _FORBIDDEN.findall("from examples.train_ppo_lidar import init_net\n")
    assert _FORBIDDEN.findall("import examples\n")
    assert not _FORBIDDEN.findall("from .examples.train_ppo_lidar import init_net\n")
    assert not _FORBIDDEN.findall("from apx_torch.examples import train_ppo_lidar\n")


def test_chip_smoke_imports_no_jax_or_apx():
    assert not _FORBIDDEN.findall((ROOT / "chip_smoke.py").read_text())


def test_make_vec_defaults_to_cuda():
    import apx_torch

    if torch.cuda.is_available():
        for env_id in ("LIDARLocRooms-v0", "CircleSquare-v0", "LightDark-v0"):
            _, params = apx_torch.make_vec(env_id, 2)
            assert params.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            apx_torch.make_vec("LIDARLocRooms-v0", 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            apx_torch.make("LIDARLocMaze-v0")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            apx_torch.make_vec("CircleSquare-v0", 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            apx_torch.make_vec("LightDark-v0", 2)
        for env_id in ("TinyImageNetLoc-v0", "MNIST-test-v0", "DoubleCircleSquare-v0"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                apx_torch.make_vec(env_id, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            apx_torch.make("CircleSquareHideAndSeek-v0")


def test_training_entry_points_default_to_cuda():
    """The recipes, the dry run and the examples run on the card unless
    given ``device="cpu"``; without one they raise, with no CPU fallback."""
    from apx_torch.examples import rollout_functional, train_ppo_lidar, train_r2d2_mesh
    from apx_torch import graft_entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = [lambda: train_ppo_lidar.init_net(torch.Generator()),
             lambda: train_ppo_lidar.PPONet(),
             lambda: train_r2d2_mesh.init_r2d2_net(torch.Generator()),
             lambda: train_ppo_lidar.main(num_envs=4, iters=1, quiet=True),
             lambda: rollout_functional.run(num_envs=4, steps=1),
             graft_entry.entry, graft_entry.dryrun_multichip]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


_NO_GYM_SCRIPT = """
import sys
import numpy as np
import torch
sys.modules["gymnasium"] = None
sys.modules["PIL"] = None
sys.modules["imageio"] = None
torch.set_num_threads(1)
import apx_torch.compat as apc
from apx_torch.compat.stats import VectorRegressionStats
for env_id, n, steps in (("LIDARLocRooms-v0", 4, 102), ("LightDark-v0", 4, 5),
                         ("CircleSquare-v0", 4, 18)):
    core = apc.make_core(env_id, n, device="cpu")
    obs, info = core.reset(seed=0)
    stats = VectorRegressionStats(n)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        act = {"action": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
               "prediction": rng.uniform(-1, 1, (n, 2)).astype(np.float32)}
        obs, reward, term, trunc, info = core.step(act)
        if not env_id.startswith("Circle"):
            info = stats.update(act, term, trunc, info)
    assert reward.dtype == np.float64 and np.isfinite(reward).all()
try:
    apc.make_vec("LIDARLocRooms-v0", 2, device="cpu")
except ImportError as exc:
    assert "gymnasium" in str(exc), exc
    print("RAISED", exc)
try:
    apc.make("CircleSquare-v0", device="cpu")
except ImportError as exc:
    assert "gymnasium" in str(exc), exc
else:
    raise AssertionError("make without gymnasium did not raise")
try:
    apc.ensure_active_perception_env
except ImportError as exc:
    assert "gymnasium" in str(exc), exc
else:
    raise AssertionError("the class layer imported without gymnasium")
# The perception module's engine: reset, steps across the lockstep
# rollover and the unique sampler, numpy out.
from apx_torch.compat.dataset_classes import CircleSquareDataset
from apx_torch.compat.perception_module import ImagePerceptionConfig, ImagePerceptionModule
mod = ImagePerceptionModule(4, ImagePerceptionConfig(dataset=CircleSquareDataset(),
                                                     prefetch=False), device="cpu")
mod.seed(0)
obs, info = mod.reset()
for _ in range(18):
    obs, reward, term, trunc, info = mod.step(np.full((4, 2), 0.2), np.zeros(4))
assert obs["glimpse"].shape == (4, 5, 5, 1) and obs["glimpse"].dtype == np.float32
assert mod.sample_unique_glimpse_positions().shape == (4, 2)
from apx_torch.tools import parse_trace
from apx_torch.ops import glimpse_study
res = glimpse_study.run_study("cpu", n=4, hw=(12, 12), c=3, sensor_size=(3, 3), reps=1,
                              gather_rows=8, gather_bytes=8)
assert res["row_gather"]["same_bytes"]
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("gymnasium", "PIL", "imageio", "jax", "apx"))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_compat_core_runs_without_gymnasium_or_pil():
    """The adapter core resets and steps (LIDAR across its boundary,
    LightDark, CircleSquare across its LOCKSTEP boundary) with gymnasium,
    PIL and imageio unimportable; ``make_vec``, ``make`` and the class
    layer's ``ensure_*`` then raise an ImportError that names gymnasium.
    The perception module's engine, ``parse_trace`` and ``glimpse_study``
    import and run without them too."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _NO_GYM_SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "RAISED" in out.stdout and "BAD []" in out.stdout
