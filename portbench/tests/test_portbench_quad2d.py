"""The 2D quadrotor's collect cell, ``quad2d_stab_ppo.collect_b16k``: the
harness finds it by its files alone (configuration, family, traffic,
driver, limits), runs it small on the CPU and judges it ``correct``; every
cell of the benchmark run small loads no JAX module; the TF32 control and
each planted fault fail its limits; the collect readers read K8 by the
configuration's kernel name; and on a card (marker ``card``) the cell runs
end to end, and each planted fault fails its limits at the cell's load."""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import pb_helpers
import pytest
import torch

from portbench import families, harness, trace, yardstick
from portbench.calibrate import collect_control
from portbench.drivers import collect
from portbench.metrics import _shapes

CELL = "quad2d_stab_ppo.collect_b16k"
CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
COLLECT_METRICS = ["policy_kernel_roofline.collect", "mfu.collect", "device_idle_share.collect"]


def _small():
    cell = harness.resolve(CELL)
    cell.traffic.update(pb_helpers.SMALL["collect"])
    return cell


def _run_small():
    res, numbers = harness.run_cell(_small(), pb_helpers.SEED, 1.0, False, torch.device("cpu"),
                                    time.perf_counter())
    return res["correct"], numbers


def test_cell_is_found_by_its_files():
    cell = harness.resolve(CELL)
    assert cell.config["family"] == "quad2d" and cell.chips == 1
    assert families.load("quad2d").DIMS == (6, 2)
    assert cell.traffic["driver"] == "collect_held_rows"
    assert (cell.traffic["num_envs"], cell.traffic["rollout_steps"]) == (16384, 360)
    assert set(cell.limits["limits"]) == {"record_gap", "sampled_calls_missing"}
    assert cell.limits["limits"]["sampled_calls_missing"] == 0
    assert cell.end_to_end == ["setup_s", "collect_env_steps_per_s"]
    assert cell.per_layer == COLLECT_METRICS
    assert issubclass(harness.driver(cell).Job, collect.Job)


def test_cell_runs_small_and_is_correct():
    correct, numbers = _run_small()
    assert correct, numbers
    assert numbers["record_gap"] < 1e-5, numbers


def test_every_cell_runs_small_with_no_jax_module():
    """Each cell of BENCHMARK.json run small in one process, at the sizes
    ``pb_helpers.SMALL`` gives its kind (a train cell is one whose traffic
    has ``check_steps``, as ``calibrate.py`` chooses), leaves no JAX module
    loaded."""
    code = (
        "import sys, time, torch; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import pb_helpers\n"
        "from portbench import harness\n"
        "for name in %r:\n"
        "    cell = harness.resolve(name)\n"
        "    kind = 'train' if 'check_steps' in cell.traffic else 'collect'\n"
        "    cell.traffic.update(pb_helpers.SMALL[kind])\n"
        "    res, numbers = harness.run_cell(cell, pb_helpers.SEED, 1.0, False,\n"
        "                                    torch.device('cpu'), time.perf_counter())\n"
        "    assert res['correct'], (name, numbers)\n"
        "print(harness.forbidden_modules())\n") % (str(harness.ROOT),
                                                    str(harness.ROOT / "portbench" / "tests"),
                                                    CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_collect_control_is_not_correct():
    c = _small()
    job = harness.driver(c).Job(c, pb_helpers.SEED, torch.device("cpu"))
    for _ in range(int(c.traffic["sample_range"])):
        job.unit()
    numbers = collect_control(job)
    assert numbers["record_gap"] > c.limits["limits"]["record_gap"], numbers


# Each fault wraps a function of the program that K8's plain path and its
# CUDA path both call, so that it plants the same error on the CPU and on
# the card.


def _wrap_rollout(mp, edit):
    """Puts ``edit(orig, p, rows, weights, seed)`` in K8's entry's place; the
    wrapper carries the launch counters that the CUDA path adds to."""
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    orig = PQ.planar_policy_rollout

    def rollout(p, rows, weights, seed, group=None):
        return edit(orig, p, rows, weights, seed)

    rollout.launches, rollout.obs_launches = orig.launches, orig.obs_launches
    mp.setattr(PQ, "planar_policy_rollout", rollout)


def _state_unchanged(mp):
    """Every step's state is the call's start state, and so is the end."""

    def edit(orig, p, rows, weights, seed):
        out, traj = orig(p, rows, weights, seed)
        out, traj = out.clone(), traj.clone()
        traj[:, :6] = rows[None, :6]
        out[:6] = rows[:6]
        return out, traj

    _wrap_rollout(mp, edit)


def _half_batch(mp):
    def edit(orig, p, rows, weights, seed):
        h = rows.shape[1] // 2
        out, traj = orig(p, rows[:, :h].contiguous(), weights, seed)
        full = torch.zeros((traj.shape[0], traj.shape[1], rows.shape[1]), dtype=traj.dtype,
                           device=traj.device)
        full[..., :h] = traj
        return torch.cat([out, rows[:, h:]], 1), full

    _wrap_rollout(mp, edit)


def _answer_altered(mp):
    def edit(orig, p, rows, weights, seed):
        out, traj = orig(p, rows, weights, seed)
        traj = traj.clone()
        traj[5, 7, 3] += 0.01  # the second action of one env at one step
        return out, traj

    _wrap_rollout(mp, edit)


def _held_mass_off(mp):
    """The mass row 1% off at the reset: the start check reads the held
    draw relative to itself."""
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    orig = PQ.reset_rows

    def reset_rows(p, env_seeds):
        rows = orig(p, env_seeds)
        rows[PQ.rows_layout(6)["MASS"], 3] *= 1.01
        return rows

    mp.setattr(PQ, "reset_rows", reset_rows)


FAULTS = [_state_unchanged, _half_batch, _answer_altered, _held_mass_off]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_fault_turns_correct_false(fault, monkeypatch):
    correct, _ = _run_small()
    assert correct
    fault(monkeypatch)
    correct, numbers = _run_small()
    assert not correct, numbers


def test_sampled_call_never_made_is_not_correct():
    c = _small()
    c.traffic["cpu_units"] = 0  # the run makes the first call alone
    res, numbers = harness.run_cell(c, pb_helpers.SEED, 1.0, False, torch.device("cpu"), 0.0)
    assert numbers["sampled_calls_missing"] > 0 and not res["correct"], numbers


def test_collect_readers_read_k8():
    cell = harness.resolve(CELL)
    job = types.SimpleNamespace(cell=cell, B=16384, T=360)
    fam = families.load("quad2d")
    least = yardstick.least_seconds(*yardstick.policy_call(fam.STEP_OPS, fam.STATE_ROWS, 6, 2,
                                                           64, 16384, 360))
    dur = int(round(least * 10 * 1e9))  # K8 at a tenth of its roofline
    name = "void (anonymous namespace)::quad_planar_policy_rollout_kernel<6, 2, 64, 8, false>"
    ops = [(name, 0, dur), (name, dur, 2 * dur)]
    tr = trace.Trace(device_ops=ops, host_ops=[], start_ns=0, end_ns=2 * dur, units=2, job=job)
    assert _shapes.policy_roofline(tr) == pytest.approx(10.0, rel=1e-6)
    mfu = harness.reader(cell, "mfu.collect")(tr)
    assert 0.0 < mfu < 10.0  # the rollout's work, no sampling, over the same time
    assert harness.reader(cell, "device_idle_share.collect")(tr) == pytest.approx(0.0)


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_on_the_card(traced):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                          "2147485000", "--seconds", "3", "--trace", str(traced)],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    if traced:
        assert set(res["metrics"]) == set(COLLECT_METRICS), res["metrics"]
        top = res["breakdown"]["device_ops"][0][0]
        assert "quad_planar_policy_rollout_kernel" in top, res["breakdown"]
    else:
        assert set(res["metrics"]) == {"setup_s", "collect_env_steps_per_s"}


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_fault_at_the_cells_load_on_the_card(fault, monkeypatch):
    """The cell at its own traffic (B = 16,384, T = 360, K8's CUDA path)
    with the fault planted: not ``correct``.  Prints the numbers (``-s``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fault(monkeypatch)
    res, numbers = harness.run_cell(harness.resolve(CELL), 2147486000, 1.0, False,
                                    torch.device("cuda", 0), time.perf_counter())
    print(fault.__name__[1:], numbers, res["compared"])
    assert not res["correct"], numbers
