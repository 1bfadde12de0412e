"""Same-call A/B of the host-bound paths that a change to the vector step
moves: PPO training, the eager bench step and the compat rows, each run
in every given checkout in turn (for example parent, change, change,
parent), one process per measurement, on one card.

    python -m apx_torch.tools.host_paths_ab --trees OLD . . OLD [--out FILE]
        [--bench-envs E[:N] ...] [--profile-envs E ...]

Each process starts in the checkout's root, so it runs that checkout's
``apx_torch``. Measured:

* ``ppo``: ``train_ppo_lidar.make_train_iter`` on LIDARLocRooms-v0 at
  N=1024, rollout 32, 2 epochs x 4 minibatches, ``PPO_ITERS`` iterations;
  the rollout and update ms of each and the env-steps/s including the
  update over all but the first (``chip_smoke.py``'s ``train ppo``);
* ``bench``: ``python -m apx_torch.bench --env E [--num-envs N]`` (E in
  ``--bench-envs``, default ``BENCH_ENVS``), its eager and graph ms per
  step and device busy us per step;
* ``profile``: ``python -m apx_torch.bench --profile --env E`` (E in
  ``--profile-envs``, none by default), the eager step's launches and busy ms per step and
  the port's kernels' share;
* ``compat``: ``python -m apx_torch.bench --compat --env E`` (E in
  ``COMPAT_ENVS``), its ms per step and host breakdown.

Prints (and appends to ``--out``) one JSON line per measurement with the
checkout's label, and the card's name and power limit as nvidia-smi
reads them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

__all__ = ["PPO_ITERS", "BENCH_ENVS", "COMPAT_ENVS", "main"]

PPO_ITERS = 6
BENCH_ENVS = ("light_dark", "lidar_rooms")
COMPAT_ENVS = ("lidar_rooms", "circle_square")

_PPO = r"""
import json, time, torch
import apx_torch
from apx_torch.examples.train_ppo_lidar import ClipAdam, init_net, make_train_iter
dev = torch.device("cuda")
n, t_len, iters = 1024, 32, %d
venv, params = apx_torch.make_vec("LIDARLocRooms-v0", n, device=dev)
g = torch.Generator(dev).manual_seed(0)
obs, state, _ = venv.reset(params, g)
net = init_net(g, params.map_bank.map_hw, dev)
opt = ClipAdam(0.5, 3e-4)
opt_state = opt.init(net)
train_iter = make_train_iter(venv, opt, n, t_len)
rows = []
for i in range(iters):
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs, mean_r = train_iter(net, opt_state, state, obs, g, params, stats=stats)
    torch.cuda.synchronize()
    rows.append({"wall_ms": 1e3 * (time.perf_counter() - t0),
                 "rollout_ms": 1e3 * stats["rollout_s"], "update_ms": 1e3 * stats["update_s"],
                 "mean_reward": float(mean_r)})
steady = rows[1:]
print(json.dumps({"iterations": rows, "env_steps_per_s_incl_update":
                  n * t_len * len(steady) / (1e-3 * sum(r["wall_ms"] for r in steady))}))
""" % PPO_ITERS


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _last_json(out: str) -> dict:
    for line in reversed(out.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise ValueError(f"no JSON line in the output: {out[-2000:]}")


def _run(tree: str, argv: list[str], timeout: int) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
    p = subprocess.run([sys.executable, *argv], cwd=tree, env=env, capture_output=True,
                       text=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"{argv} in {tree} exited {p.returncode}: {p.stderr[-3000:]}")
    return _last_json(p.stdout)


def _measure(tree: str, timeout: int, bench_envs, profile_envs) -> list[dict]:
    rows = [{"what": "ppo", **_run(tree, ["-c", _PPO], timeout)}]
    for spec in bench_envs:
        env, _, n = spec.partition(":")
        rec = _run(tree, ["-m", "apx_torch.bench", "--env", env,
                          *(["--num-envs", n] if n else [])], timeout)
        rows.append({"what": f"bench {spec}", "eager_ms_per_step": rec.get("eager_ms_per_step"),
                     "graph_ms_per_step": rec.get("graph_ms_per_step"),
                     "device_busy_us_per_step": rec.get("device_busy_us_per_step")})
    for env in profile_envs:
        rec = _run(tree, ["-m", "apx_torch.bench", "--profile", "--env", env], timeout)
        rows.append({"what": f"profile {env}", **{k: rec.get(k) for k in (
            "kernel_launches_per_step", "device_busy_ms_per_step", "device_idle_share",
            "port_kernels_ms_per_step", "port_kernels_launches_per_step")}})
    for env in COMPAT_ENVS:
        rec = _run(tree, ["-m", "apx_torch.bench", "--compat", "--env", env], timeout)
        rows.append({"what": f"compat {env}", "ms_per_step": rec.get("ms_per_step"),
                     "breakdown": rec.get("breakdown")})
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="checkout roots, in the order they run (labels: their paths)")
    ap.add_argument("--out", default=None, help="a JSON-lines file to append to")
    ap.add_argument("--timeout", type=int, default=600, help="seconds per process")
    ap.add_argument("--bench-envs", nargs="+", default=list(BENCH_ENVS),
                    help="bench workloads, each E or E:N (N envs)")
    ap.add_argument("--profile-envs", nargs="+", default=[], help="workloads to profile")
    args = ap.parse_args(argv)
    smi = _smi()
    for k, tree in enumerate(args.trees):
        for row in _measure(tree, args.timeout, args.bench_envs, args.profile_envs):
            line = json.dumps({"run": k, "tree": tree, **row, "nvidia_smi": smi})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
