"""``apx_torch.tools.host_paths_ab``'s plan on the CPU: which processes it
starts in which checkout, in which order, with the measurements replaced
by a recorder (they need a card)."""

import json

import pytest

from apx_torch.tools import host_paths_ab


@pytest.fixture
def recorded(monkeypatch):
    calls = []

    def fake_run(tree, argv, timeout):
        calls.append((tree, argv))
        return {"graph_ms_per_step": 0.1, "kernel_launches_per_step": 5.0, "ms_per_step": 1.0}

    monkeypatch.setattr(host_paths_ab, "_run", fake_run)
    monkeypatch.setattr(host_paths_ab, "_smi", lambda: "card, 700 W")
    return calls


def test_default_parts_run_ppo_bench_and_compat_in_each_tree(recorded, capsys):
    assert host_paths_ab.main(["--trees", "old", "new"]) == 0
    per_tree = 1 + len(host_paths_ab.BENCH_ENVS) + len(host_paths_ab.COMPAT_ENVS)
    assert [t for t, _ in recorded] == ["old"] * per_tree + ["new"] * per_tree
    assert recorded[0][1][0] == "-c"  # the PPO program
    assert not any("--profile" in a for _, a in recorded)  # no profile row by default
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["run"] for x in lines] == [0] * per_tree + [1] * per_tree
    assert all(x["nvidia_smi"] == "card, 700 W" for x in lines)


def test_bench_envs_with_sizes_and_profiles(recorded, capsys, tmp_path):
    out = tmp_path / "ab.jsonl"
    host_paths_ab.main(["--trees", "p", ".", ".", "p",
                        "--bench-envs", "lidar_maze", "lidar_rooms:16384",
                        "--profile-envs", "lidar_rooms", "--out", str(out)])
    per_tree = 1 + 2 + 1 + len(host_paths_ab.COMPAT_ENVS)
    argv = [a for _, a in recorded[1:4]]
    assert argv == [["-m", "apx_torch.bench", "--env", "lidar_maze"],
                    ["-m", "apx_torch.bench", "--env", "lidar_rooms", "--num-envs", "16384"],
                    ["-m", "apx_torch.bench", "--profile", "--env", "lidar_rooms"]]
    assert [t for t, _ in recorded] == (["p"] * per_tree + ["."] * 2 * per_tree
                                        + ["p"] * per_tree)
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["what"] for r in rows[:per_tree]] == [
        "ppo", "bench lidar_maze", "bench lidar_rooms:16384", "profile lidar_rooms",
        *(f"compat {e}" for e in host_paths_ab.COMPAT_ENVS)]
    assert rows[3]["kernel_launches_per_step"] == 5.0
    assert len(capsys.readouterr().out.splitlines()) == 4 * per_tree
