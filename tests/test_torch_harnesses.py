"""The port's counterparts of the six ``benchmarks/`` harnesses without a
twin (``scripts/*_port.py``), each ``main`` in process on the CPU at a tiny
size: the keys of the JSON each prints and writes under ``--out``.  The
fidelity harness also meets the JAX suite's float64 bar (4 ulp a step,
tests/test_dynamics.py) where it steps as the JAX harness does."""

import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: small-batch loops stall when the test
    workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def script(name):
    path = os.path.join(ROOT, "scripts", f"{name}_port.py")
    spec = importlib.util.spec_from_file_location(f"{name}_port", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_fidelity(capsys, tmp_path):
    out = tmp_path / "fidelity.json"
    line = script("fidelity").main(steps=50, device="cpu", out=str(out))
    assert last_json(capsys) == line and line["device"] == "cpu"
    for case in ("cartpole", "quad2d", "quad3d", "quad3d_k1"):
        for m in ("f32_step_max_ulp", "f32_step_max_rel", "f32_traj_max_rel", "f64_step_max_ulp"):
            assert f"{case}_{m}" in line
    for case in ("cartpole", "quad2d", "quad3d"):
        assert line[f"{case}_f64_step_max_ulp"] <= 4, case
    assert line["quad3d_f32_step_max_rel"] < 1e-4
    cases = json.loads(out.read_text())["cases"]
    assert set(cases) == {"cartpole", "quad2d", "quad3d", "quad3d_k1"}


def test_on_device_checks(capsys, tmp_path):
    rec = script("on_device_checks").main(device="cpu", batch=64, out=str(tmp_path / "o.json"))
    assert last_json(capsys)["value"] == rec["value"] < 2e-4
    for name, r in rec["engines"].items():
        assert r["reset_rel_err"] == 0.0 and r["episode_idx_rel_err"] == 0.0, name
        assert r["episodes"] > 0, name
    assert json.loads((tmp_path / "o.json").read_text())["engines"].keys() == {
        "quad3d", "cartpole", "quad2d"}


@pytest.mark.parametrize("fast", [False, True])
def test_rl_throughput(capsys, fast):
    rec = script("rl_throughput").main(batch=16, steps=8, iters=1, fast=fast, device="cpu")
    assert last_json(capsys) == rec
    assert rec["metric"] == "ppo_train_env_steps_per_sec" and rec["value"] > 0
    assert rec["collector"] == ("fast_policy_kernel" if fast else "general_engine")
    assert set(rec["launches_per_train_step"]) == {"k1", "k3", "k4"} and rec["card"] == "cpu"


def test_rl_equivalence(capsys):
    rec = script("rl_equivalence").main(n_iters=1, batch=16, steps=8, eval_episodes=4,
                                        eval_steps=20, device="cpu")
    assert last_json(capsys)["passed"] == rec["passed"]
    assert [r["collector"] for r in rec["runs"]] == ["general_engine", "fast_policy_kernel"]
    # One seed, one evaluation: both collectors start from the same return.
    assert rec["runs"][0]["return_before"] == rec["runs"][1]["return_before"]
    for k in ("general_engine_learned", "fast_learned", "ratio_above_half", "value"):
        assert k in rec


def test_scaling(capsys):
    rec = script("scaling").main(envs_per_device=16, steps=2, iters=1, device="cpu")
    assert rec["n_rows"] == len(rec["rows"]) == 1 and "one row" in rec["note"]
    row = rec["rows"][0]
    assert row["devices"] == 1 and row["scaling_efficiency"] == 1.0 and row["envs"] == 16
    assert row["per_step_us"] > 0


def test_scaling_multihost(capsys, tmp_path):
    rec = script("scaling_multihost").main(max_hosts=2, envs_per_host=16, steps=2, iters=1,
                                           trials=1, device="cpu", out=str(tmp_path / "s.json"))
    assert [r["hosts"] for r in rec["rows"]] == [1, 2]
    two = rec["rows"][1]
    assert two["ranks"] == 2 and two["backend"] == "gloo" and two["envs"] == 32
    assert two["efficiency_wall"] > 0 and two["efficiency_slope"] > 0
    assert "CPU cores" in rec["shares"] and rec["value"] == two["efficiency_wall"]
    assert len(json.loads((tmp_path / "s.json").read_text())["rows"]) == 2
