"""The port's example scripts (``scripts/*_port.py``) in process on the CPU,
at sizes that keep this file near a minute: the lines that
tests/test_examples.py looks for in their JAX twins, the files they write,
and, where it is cheap, the JAX example's own number (the PID tracking RMSE
of the first 50 steps, rtol 1e-3: a float32 closed loop)."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: these small-batch loops launch many short
    parallel regions, which stall when the test workers outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(path):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script(name):
    return load(os.path.join(ROOT, "scripts", f"{name}_port.py"))


def test_tracking_example(capsys, tmp_path):
    rmse = script("tracking").main(max_steps=50, plot=str(tmp_path / "flight.png"), device="cpu")
    out = capsys.readouterr().out
    assert "steps/sec" in out and "realtime speedup" in out and "(cpu)" in out
    assert (tmp_path / "flight.png").stat().st_size > 0
    load(os.path.join(ROOT, "examples", "tracking.py")).main(max_steps=50)
    want = float(re.search(r"rmse: ([\d.]+)", capsys.readouterr().out).group(1))
    assert rmse == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("task", ["cartpole", "quadrotor"])
def test_verbose_api_example(task, capsys):
    env = script("verbose_api").main(task=task, device="cpu")
    out = capsys.readouterr().out
    assert "reset -> obs" in out and "constraint_values" in out
    assert env.device == torch.device("cpu") and f"== {task} (cpu) ==" in out


def test_scenario_rehearsal_example(tmp_path, capsys):
    """The firmware-in-the-loop 'line' scenario (390 control steps of the
    fused 500 Hz block): tracking within half a meter, as the JAX example's
    test asks."""
    errs = script("scenario_rehearsal").main(scenario="line", out_dir=str(tmp_path),
                                             video=False, device="cpu")
    out = capsys.readouterr().out
    assert "tracked setpoints" in out
    m = re.search(r"mean err=([\d.]+)", out)
    assert m and float(m.group(1)) < 0.5 and float(m.group(1)) == pytest.approx(errs.mean(),
                                                                                abs=5e-4)


def test_rl_training_example(tmp_path, capsys):
    """config -> registry make -> learn with the logger -> save -> eval ->
    learning curve, on 12800 env steps; the checkpoint resumes into a fresh
    controller."""
    import safe_control_gym_torch as tp
    from safe_control_gym_torch.utils.configuration import ConfigFactory

    before, after = script("rl_training").main(max_steps=12800, out_dir=str(tmp_path),
                                               device="cpu")
    out = capsys.readouterr().out
    assert "eval return after training" in out and np.isfinite([before, after]).all()
    for f in ("checkpoint", "learning_curve.png", "config.yaml",
              os.path.join("logs", "train_policy_loss.log")):
        assert os.path.exists(tmp_path / f), f
    config = ConfigFactory().merge(args=["--restore", str(tmp_path)])
    assert config.algo == "ppo" and config.algo_config["rollout_batch_size"] == 64
    ppo = tp.make(config.algo, tp.make(config.task, device="cpu", **config.task_config),
                  seed=config.seed, **config.algo_config)
    ppo.load(tmp_path / "checkpoint")
    assert ppo.state.total_steps == 12800
