"""A run's process: no JAX module loaded, no result without a card, and
on a card (marker ``card``) each cell end to end at a short window."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, time, torch; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import pb_helpers\n"
        "from portbench import harness\n"
        "for c in %r: assert pb_helpers.run_small(c)[0]\n"
        "print(harness.forbidden_modules())\n") % (str(ROOT), str(ROOT / "portbench" / "tests"),
                                                    CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "safe_control_gym_tpu_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_on_the_card(cell, traced):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2147484000", "--seconds", "3", "--trace", str(traced)],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]
