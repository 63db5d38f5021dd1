"""The harness finds a configuration, a traffic mix, a cell and a metric
that are added as files (and entries of BENCHMARK.json) alone."""

from __future__ import annotations

import json
import shutil
import sys
import time

import torch

import pb_helpers

from portbench import families, harness

CELL = "quad3d_fig8_ppo_h32.train_tiny"


def _add_files(root):
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(harness.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "quad3d_fig8_ppo.json").read_text())
    cfg["name"] = "quad3d_fig8_ppo_h32"
    cfg["ppo"]["hidden_dim"] = 32
    (pb / "configs" / "quad3d_fig8_ppo_h32.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "train_tiny.json").write_text(json.dumps(
        {"driver": "train", "num_envs": 16, "rollout_steps": 8, "minibatches": 2,
         "check_steps": 2, "trace_units": 1, "cpu_units": 1}))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "change_norm_gap": 1e-4}}))
    (pb / "metrics" / "tiny_units.py").write_text("def read(trace):\n    return trace.units\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "quad3d_fig8_ppo_h32", "source": "https://example.org",
                             "file": "portbench/configs/quad3d_fig8_ppo_h32.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "quad3d_fig8_ppo_h32",
                               "traffic": "train_tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "tiny_units", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "trainer",
                               "moves": "train_env_steps_per_s", "workloads": [CELL]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"].startswith("train_"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_are_found(tmp_path):
    _add_files(tmp_path)
    cell = harness.resolve(CELL, tmp_path)
    assert cell.config["ppo"]["hidden_dim"] == 32
    assert cell.traffic["num_envs"] == 16 and cell.limits["limits"]["loss_gap"] == 1e-4
    assert cell.per_layer == ["tiny_units"]
    assert set(cell.end_to_end) == {"setup_s", "train_env_steps_per_s", "train_step_p95_ms"}

    class FakeTrace:
        units = 7

    assert harness.reader(cell, "tiny_units")(FakeTrace()) == 7
    assert harness.driver(cell).Job.__name__ == "Job"


def test_new_cell_runs_and_checks(tmp_path):
    _add_files(tmp_path)
    cell = harness.resolve(CELL, tmp_path)
    res, numbers = harness.run_cell(cell, pb_helpers.SEED, 1.0, False, torch.device("cpu"),
                                    time.perf_counter())
    assert res["correct"], numbers
    assert str(tmp_path) in harness.driver(cell).__file__


def test_metrics_of_a_cell_follow_the_benchmark_file():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.resolve(w["name"])
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert (harness.PKG / "metrics" / f"{m}.py").is_file()


def test_new_family_is_found(tmp_path, monkeypatch):
    """An env family added as its own file, with a configuration and a cell
    that name it, runs and checks; no file of the harness changes."""
    _add_files(tmp_path)
    pb = tmp_path / "portbench"
    shutil.copy(pb / "families" / "cartpole.py", pb / "families" / "cartpole_twin.py")
    monkeypatch.setattr(families, "DIR", pb / "families")
    cfg = json.loads((pb / "configs" / "cartpole_stab_ppo.json").read_text())
    cfg["name"], cfg["family"] = "cartpole_twin", "cartpole_twin"
    (pb / "configs" / "cartpole_twin.json").write_text(json.dumps(cfg))
    cell_name = "cartpole_twin.train_tiny"
    (pb / "limits" / f"{cell_name}.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "change_norm_gap": 1e-4}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cartpole_twin", "source": "https://example.org",
                             "file": "portbench/configs/cartpole_twin.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": cell_name, "config": "cartpole_twin",
                               "traffic": "train_tiny", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        cell = harness.resolve(cell_name, tmp_path)
        res, numbers = harness.run_cell(cell, pb_helpers.SEED, 1.0, False, torch.device("cpu"),
                                        time.perf_counter())
        assert res["correct"], numbers
        twin = sys.modules["portbench.families.cartpole_twin"]
        assert str(tmp_path) in twin.__file__
    finally:
        sys.modules.pop("portbench.families.cartpole_twin", None)
