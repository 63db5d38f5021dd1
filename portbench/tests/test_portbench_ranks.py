"""A cell on several cards (``ranks.py``), on the CPU: two ranks in a gloo
group.  Rank 0 is a process the test starts, which skips the harness's look
for a card and runs the rest of ``run.py``'s path; it starts the other rank
as ``run.py`` does.  The cell is added to a throwaway root by the files a
multi-card cell adds alone: a configuration, a traffic mix, a driver, the
limits and a metric reader.  Its driver does one all-reduce a unit, and its
traffic plants a load or a fault on one rank.  On a machine with two cards
or more (marker ``card``) the same cell runs through ``run.py`` over NCCL."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness, ranks

CELL = "probe.ranks"
SEED = 2**31 + 977

DRIVER = '''"""A probe of the harness's ranks: one all-reduce a unit of a small vector
on the rank's card; the check reads the sum every rank holds.  Traffic keys
``<what>_rank`` plant on that rank: ``slow`` (``slow_s`` of host sleep a
unit), ``hold`` (``hold_bytes`` held until ``free``), ``import`` (a module
named ``jax``), ``raise`` and ``hang`` (at unit ``<what>_at``), ``fault``
(its check reads 1 more)."""

import sys
import time
import types

import torch
import torch.distributed as dist


class Job:
    def __init__(self, cell, seed, device):
        self.tr = cell.traffic
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.x = torch.full((int(cell.config["width"]),), float(self.rank + 1), device=device)
        self.acc = torch.zeros_like(self.x)
        self.units, self.hold = 0, None
        if self._planted("hold"):
            self.hold = torch.ones(int(self.tr["hold_bytes"]), dtype=torch.uint8, device=device)
        if self._planted("import"):
            sys.modules["jax"] = types.ModuleType("jax")
        self.unit()

    def _planted(self, what):
        return self.tr.get(what + "_rank") == self.rank

    def unit(self):
        if self._planted("slow"):
            time.sleep(float(self.tr["slow_s"]))
        if self._planted("raise") and self.units == int(self.tr["raise_at"]):
            raise RuntimeError("a fault planted in a unit")
        if self._planted("hang") and self.units == int(self.tr["hang_at"]):
            time.sleep(3600)
        y = self.x.clone()
        dist.all_reduce(y)
        self.acc += y
        self.units += 1

    def end_to_end(self, wall, units, unit_ms):
        return {"probe_units_per_s": units / wall}

    def free(self):
        self.hold = None

    def check(self):
        want = self.units * self.world * (self.world + 1) / 2
        gap = float((self.acc - want).abs().max()) / want
        return {"sum_gap": gap + (1.0 if self._planted("fault") else 0.0)}
'''

LEAD = """
import sys, time
T = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench import harness, ranks
ranks.WINDOW_SLACK_S = {slack!r}
cell = harness.resolve({cell!r})
sys.exit(harness.report(*ranks.lead(cell, {seed!r}, {seconds!r}, False, T, {{}},
                                     device_type="cpu")))
"""


def _root(tmp_path, chips=2, **traffic):
    """A throwaway root: the benchmark as it is, and the probe cell's files."""
    root = tmp_path / "root"
    root.mkdir()
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(harness.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    (pb / "configs" / "probe.json").write_text(json.dumps({"name": "probe", "width": 4}))
    (pb / "traffic" / "ranks.json").write_text(json.dumps(
        {"driver": "probe_ranks", "trace_units": 4, "sample_range": 3, **traffic}))
    (pb / "drivers" / "probe_ranks.py").write_text(DRIVER)
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": {"sum_gap": 1e-6}}))
    (pb / "metrics" / "probe_units.py").write_text("def read(trace):\n    return trace.units\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "probe", "source": "https://example.org",
                             "file": "portbench/configs/probe.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "probe", "traffic": "ranks",
                               "chips": chips, "why": "test"})
    bench["end_to_end"].append({"name": "probe_units_per_s", "unit": "units/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": [CELL]})
    bench["per_layer"].append({"name": "probe_units", "unit": "units", "better": "higher",
                               "source": "device_trace", "layer": "harness",
                               "moves": "probe_units_per_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "tmp").mkdir()
    return root


def _env(root):
    return {**os.environ, "TMPDIR": str(root.parent / "tmp"), "OMP_NUM_THREADS": "1"}


def _left(root):
    """Processes still running whose command line names the root."""
    found = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            cmd = (d / "cmdline").read_bytes()
        except OSError:
            continue
        if str(root).encode() in cmd:
            found.append(cmd.replace(b"\0", b" ").decode())
    return found


def _lead(root, seconds=1.0, slack=ranks.WINDOW_SLACK_S, timeout=180):
    """Rank 0 on the CPU: (completed process, its seconds, its result or None)."""
    code = LEAD.format(root=str(root), slack=slack, cell=CELL, seed=SEED, seconds=seconds)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=_env(root), timeout=timeout)
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return out, time.monotonic() - t0, res


@pytest.mark.parametrize("slow", [0, 1])
def test_ranks_run_the_same_units_with_one_rank_slow(tmp_path, slow):
    root = _root(tmp_path, slow_rank=slow, slow_s=0.05)
    out, _, res = _lead(root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert res["correct"], res["compared"]
    units = res["attempted_by_rank"]
    assert units == [res["attempted"]] * 2 and res["attempted"] >= 10, units
    assert res["metrics"]["probe_units_per_s"]["value"] > 0
    assert set(res["metrics"]) == {"setup_s", "probe_units_per_s"}
    assert list(res)[-1] == "compared"
    assert out.stderr.strip().splitlines()[-1].startswith("compared sum_gap:")
    assert not _left(root) and not list((tmp_path / "tmp").iterdir())


def test_result_reports_every_card_and_the_fullest(tmp_path):
    root = _root(tmp_path, hold_rank=1, hold_bytes=256 << 20)
    out, _, res = _lead(root)
    assert out.returncode == 0, out.stderr[-3000:]
    dev = res["device"]
    assert dev["count"] == 2 and dev["platform"] == "cpu"
    peaks = dev["memory_peak_bytes_by_rank"]
    assert dev["memory_peak_bytes"] == max(peaks) == peaks[1]
    assert peaks[1] - peaks[0] > 200 << 20, peaks


def test_fault_on_rank_1_turns_correct_false(tmp_path):
    out, _, res = _lead(_root(tmp_path, fault_rank=1))
    assert out.returncode == 0, out.stderr[-3000:]
    assert not res["correct"] and res["compared"]["sum_gap"]["value"] >= 1.0


def test_merge_takes_the_worst_reading_of_each_number():
    merged = ranks.merge([{"a": 1.0, "b": 5}, {"a": 3.0, "c": 0.5}, {"a": float("nan")}])
    assert merged["b"] == 5 and merged["c"] == 0.5 and merged["a"] != merged["a"]
    assert ranks.merge([{"a": 1.0}, {"a": 3.0}]) == {"a": 3.0}


def test_forbidden_module_on_rank_1_exits_3(tmp_path):
    root = _root(tmp_path, import_rank=1)
    out, _, _ = _lead(root)
    assert out.returncode == 3 and out.stdout.strip() == "", out.stderr[-3000:]
    assert "jax" in out.stderr.strip().splitlines()[-1]
    assert not _left(root)


@pytest.mark.parametrize("what", ["raise", "hang"])
def test_a_rank_that_fails_stops_every_rank(tmp_path, what):
    """A rank that raises is seen at once (by rank 0's watch, or by gloo in
    rank 0's all-reduce); one that hangs, with rank 0 waiting in the
    all-reduce, at the window's deadline, here 3 s past its second."""
    root = _root(tmp_path, **{f"{what}_rank": 1, f"{what}_at": 3})
    out, took, _ = _lead(root, slack=3.0)
    assert out.returncode not in (0, 3) and out.stdout.strip() == "", out.stderr[-3000:]
    assert "a fault planted in a unit" in out.stderr if what == "raise" else (
        "the window outlived its deadline" in out.stderr)
    assert took < 60, took
    assert not _left(root) and not list((tmp_path / "tmp").iterdir())


def test_too_few_cards_exits_2_and_starts_no_rank(tmp_path):
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    root = _root(tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=root, env=_env(root), timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert f"{CELL} needs 2 CUDA card(s)" in out.stderr
    assert not list((tmp_path / "tmp").iterdir())


def _calibrate(root, *args, timeout=300):
    """``calibrate.py`` on the CPU, its ranks in a gloo group: (completed
    process, what it wrote)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import calibrate\n"
            "calibrate.main(%r, device_type='cpu')\n") % (str(root), [*args, "--out", "out.json"])
    env = {**_env(root), "PYTHONPATH": str(harness.ROOT)}  # the program, for the train driver
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=timeout)
    got = json.loads((root / "out.json").read_text()) if out.returncode == 0 else None
    return out, got


def test_calibration_on_ranks_keeps_the_worst_rank(tmp_path):
    root = _root(tmp_path, fault_rank=1)
    out, got = _calibrate(root, "--workload", CELL, "--seeds", f"5,{SEED}")
    assert out.returncode == 0, out.stderr[-3000:]
    assert set(got["lower"]) == {"5", str(SEED)}
    assert got["lower_reading"]["sum_gap"] == 1.0
    assert not _left(root) and not list((tmp_path / "tmp").iterdir())


TRAIN_CELL = "quad3d_fig8_ppo.train_tiny_ranks"


def test_calibration_on_ranks_runs_the_control_and_faults(tmp_path):
    """A train cell on two ranks: rank 0 reads the program against the
    reference, and on the control seed the TF32 control and both faults,
    as on one card; the limits hold the sound seeds and not a fault."""
    root = _root(tmp_path)
    pb = root / "portbench"
    (pb / "traffic" / "train_tiny.json").write_text(json.dumps(
        {"driver": "train", "num_envs": 16, "rollout_steps": 8, "minibatches": 2,
         "check_steps": 2, "trace_units": 1}))
    lim = json.loads((pb / "limits" / "quad3d_fig8_ppo.train_b32k.json").read_text())
    (pb / "limits" / f"{TRAIN_CELL}.json").write_text(json.dumps(lim))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": TRAIN_CELL, "config": "quad3d_fig8_ppo",
                               "traffic": "train_tiny", "chips": 2, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out, got = _calibrate(root, "--workload", TRAIN_CELL, "--seeds", f"7,{SEED}",
                          "--control-seeds", str(SEED))
    assert out.returncode == 0, out.stderr[-3000:]
    lim = lim["limits"]
    assert set(got["lower"]) == {"7", str(SEED)}
    assert all(got["lower_reading"][k] <= v for k, v in lim.items()), got["lower_reading"]
    assert set(got["control"]) == set(got["faults"]) == {str(SEED)}
    assert set(got["control_reading"]) == set(lim)
    faults = got["faults"][str(SEED)]
    assert set(faults) == {"half_batch", "reward_t0"}
    assert all(any(f[k] > v for k, v in lim.items()) for f in faults.values()), faults
    raw = got["raw"][str(SEED)]
    assert {"program", "reference", "first_rollout", "control", "half_batch"} <= set(raw)
    assert not _left(root) and not list((tmp_path / "tmp").iterdir())


@pytest.mark.card
@pytest.mark.parametrize("chips", [2, 4])
@pytest.mark.parametrize("traced", [0, 1])
def test_ranks_on_the_cards(tmp_path, chips, traced):
    """``run.py`` on ``chips`` cards over NCCL, rank 1 planted slow."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    root = _root(tmp_path, chips=chips, slow_rank=1, slow_s=0.01, hold_rank=chips - 1,
                 hold_bytes=1 << 30)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                          str(SEED), "--seconds", "3", "--trace", str(traced)],
                         capture_output=True, text=True, cwd=root, env=_env(root), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == chips
    assert dev["memory_peak_bytes"] == dev["memory_peak_bytes_by_rank"][-1] >= 1 << 30
    assert res["attempted_by_rank"] == [res["attempted"]] * chips
    if traced:
        assert res["metrics"]["probe_units"]["value"] == 4
        assert len(dev["busy_s_by_rank"]) == chips and dev["busy_s"] > 0
        assert (dev["busy_s"], dev["window_s"]) == (dev["busy_s_by_rank"][0],
                                                    dev["window_s_by_rank"][0])
    else:
        assert set(res["metrics"]) == {"setup_s", "probe_units_per_s"}
    assert not _left(root)


@pytest.mark.card
def test_calibration_on_the_cards(tmp_path):
    """``calibrate.py`` on two cards over NCCL, a fault planted on rank 1."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    root = _root(tmp_path, fault_rank=1)
    out = subprocess.run([sys.executable, "portbench/calibrate.py", "--workload", CELL,
                          "--seeds", f"5,{SEED}", "--out", "out.json"], capture_output=True,
                         text=True, cwd=root, env=_env(root), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads((root / "out.json").read_text())
    assert got["lower_reading"]["sum_gap"] == 1.0 and len(got["lower"]) == 2
    assert not _left(root)
