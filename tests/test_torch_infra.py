"""The port's experiment infra against the JAX package's (the twins of
tests/test_infra.py): the config merge precedence and restore
(``utils/configuration.py``), the metric loggers and their restore
(``utils/logging.py``), the misc utils (``utils/utils.py``) with the random
state round trip, torch's generators included, the run directory, and the
drone logger (``utils/drone_logger.py``).  Each case runs the same inputs
through both packages where the JAX module has the function."""

import os
import random
import time

import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_torch.utils import configuration as tcfg
from safe_control_gym_torch.utils import drone_logger as tdl
from safe_control_gym_torch.utils import logging as tlog
from safe_control_gym_torch.utils import utils as tut
from safe_control_gym_torch.utils.plotting import load_from_logs, plot_from_logs
from safe_control_gym_tpu.utils import configuration as jcfg
from safe_control_gym_tpu.utils import drone_logger as jdl
from safe_control_gym_tpu.utils import logging as jlog
from safe_control_gym_tpu.utils import utils as jut


def test_config_merge_precedence(tmp_path):
    """Defaults <- override yaml <- kv_overrides <- typed literals
    (reference configuration.py:58-97), equal to the JAX factory's."""
    ov = tmp_path / "ov.yaml"
    ov.write_text(yaml.safe_dump({
        "task_config": {"ctrl_freq": 60, "episode_len_sec": 5},
        "algo_config": {"lr": 0.001},
    }))
    args = ["--tag", "t1", "--seed", "7", "--overrides", str(ov),
            "--kv_overrides", "algo_config.lr=3e-4", "task_config.ctrl_freq=120",
            "task_config.name=fast"]
    cfg = tcfg.ConfigFactory().merge(args=args)
    assert cfg.tag == "t1" and cfg.seed == 7
    assert cfg.task_config["ctrl_freq"] == 120  # kv beats yaml
    assert abs(cfg.algo_config["lr"] - 3e-4) < 1e-12 and isinstance(cfg.algo_config["lr"], float)
    assert cfg.task_config["name"] == "fast"  # a plain word stays a string
    assert cfg.task_config["episode_len_sec"] == 5  # yaml survives
    assert isinstance(cfg, tcfg.AttrDict) and cfg.task_config.ctrl_freq == 120
    assert cfg == jcfg.ConfigFactory().merge(args=args)


def test_config_restore_roundtrip(tmp_path):
    tcfg.save_config({"tag": "x", "task_config": {"a": 1}}, str(tmp_path))
    cfg = tcfg.ConfigFactory().merge(args=["--restore", str(tmp_path)])
    assert cfg.task_config["a"] == 1
    assert cfg == jcfg.ConfigFactory().merge(args=["--restore", str(tmp_path)])


@pytest.mark.parametrize("args, override", [
    (["--algo", "ppo", "--task", "quadrotor"], None),
    (["--algo", "sac", "--task", "cartpole", "--seed", "3", "--kv_overrides",
      "algo_config.hidden_dim=32", "task_config.ctrl_freq=50"],
     {"algo_config": {"rollout_batch_size": 8}, "task_config": {"task": "stabilization"}}),
])
def test_registry_config_merge_matches_jax(args, override):
    """An algo and a task from the registries' defaults, then a
    ``config_override`` and kv overrides: the same dict as the JAX factory's."""
    cfg = tcfg.ConfigFactory().merge(args=args, config_override=override)
    assert cfg == jcfg.ConfigFactory().merge(args=args, config_override=override)
    assert cfg.algo_config["gamma"] == 0.99


def test_file_logger_restore_truncation(tmp_path):
    """FileLogger.restore(step) drops rows past the restore point
    (reference logging.py:95-124): the same files as the JAX logger's."""
    for mod, d in ((tlog, tmp_path / "t"), (jlog, tmp_path / "j")):
        fl = mod.FileLogger(str(d))
        for s in range(10):
            fl.log("loss", float(s), s)
        fl.close()
        fl2 = mod.FileLogger(str(d))
        fl2.restore(step=5)
        fl2.log("loss", 99.0, 5)
        fl2.close()
    text = (tmp_path / "t" / "logs" / "loss.log").read_text()
    assert text == (tmp_path / "j" / "logs" / "loss.log").read_text()
    steps = [int(line.split()[0]) for line in text.splitlines()]
    assert max(steps) == 5 and text.splitlines()[-1] == "5 99.0"


def test_experiment_logger_and_plotting(tmp_path, capsys):
    d1, d2 = tmp_path / "seed0", tmp_path / "seed1"
    for i, d in enumerate((d1, d2)):
        lg = tlog.ExperimentLogger(str(d), log_std_out=False)
        for s in range(0, 100, 10):
            lg.add_scalar("eval/return", float(s + i), s)
        lg.add_scalars({"loss": 0.5}, 90, prefix="train")
        capsys.readouterr()
        lg.dump_scalars()
        lg.close()
    table = capsys.readouterr().out  # the second run's
    jl = jlog.ExperimentLogger(str(tmp_path / "j"), log_std_out=False)
    for s in range(0, 100, 10):
        jl.add_scalar("eval/return", float(s + 1), s)
    jl.add_scalars({"loss": 0.5}, 90, prefix="train")
    jl.dump_scalars()
    jl.close()
    assert capsys.readouterr().out == table
    assert (d2 / "logs" / "eval_return.log").read_text() == \
        (tmp_path / "j" / "logs" / "eval_return.log").read_text()
    logs = load_from_logs(str(d1))
    assert any("return" in k for k in logs)
    out = tmp_path / "curve.png"
    plot_from_logs([str(d1), str(d2)], metric="eval/return", out_path=str(out), window=2)
    assert out.exists() and out.stat().st_size > 0


def test_stdout_logger_writes_its_file(tmp_path, capsys):
    lg = tlog.ExperimentLogger(str(tmp_path), log_std_out=True)
    lg.add_scalar("x", 1.5, 3)
    lg.dump_scalars()
    lg.load(2)  # restore before step 3: the x row goes
    lg.close()
    assert "1.5000" in capsys.readouterr().out
    assert "1.5000" in (tmp_path / "std_log.txt").read_text()
    assert (tmp_path / "logs" / "x.log").read_text() == ""


def test_misc_utils(tmp_path):
    y = tmp_path / "x.yaml"
    y.write_text("a: 1\n")
    assert tut.read_file(str(y)) == jut.read_file(str(y)) == {"a": 1}
    j = tmp_path / "x.json"
    j.write_text('{"b": 2}')
    assert tut.read_file(str(j)) == {"b": 2}
    t = tmp_path / "x.txt"
    t.write_text("plain")
    assert tut.read_file(str(t)) == "plain"
    out = tut.merge_dict({"a": {"b": 1, "c": 2}}, {"a": {"b": 9}})
    assert out == {"a": {"b": 9, "c": 2}} == jut.merge_dict({"a": {"b": 1, "c": 2}}, {"a": {"b": 9}})
    d = {}
    tcfg.deep_set(d, "x.y.z", 3)
    assert d == {"x": {"y": {"z": 3}}}


def test_random_state_round_trip_includes_torch():
    """set_seed seeds Python, NumPy and torch; a snapshot replays the draws
    of all three (the CUDA generators' too where a card is present)."""
    tut.set_seed(123)
    snap = tut.get_random_state()
    assert ("cuda" in snap) == torch.cuda.is_available()
    a = (np.random.rand(3), torch.rand(3), random.random())
    tut.set_random_state(snap)
    b = (np.random.rand(3), torch.rand(3), random.random())
    np.testing.assert_array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1]) and a[2] == b[2]
    tut.set_seed(123)
    assert torch.equal(torch.rand(3), a[1])
    jut.set_seed(123)
    np.testing.assert_array_equal(np.random.rand(3), a[0])  # the host draws JAX seeds


def test_set_dir_from_config(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = tcfg.AttrDict({"tag": "exp", "seed": 4, "output_dir": str(tmp_path / "results"),
                         "task_config": {"quad_type": 3, "gates": ((0.5, 1.0),)}})
    run_dir = tut.set_dir_from_config(cfg)
    assert cfg.output_dir == run_dir and os.path.isdir(run_dir)
    rel = os.path.relpath(run_dir, tmp_path / "results")
    assert rel.startswith(os.path.join("exp", "seed4_"))
    with open(os.path.join(run_dir, "config.yaml")) as f:
        saved = yaml.safe_load(f)
    assert saved["task_config"]["quad_type"] == 3 and saved["seed"] == 4
    assert os.path.exists(os.path.join(run_dir, "cmd.txt"))


def test_sync_paces_to_the_wall_clock():
    t0 = time.time()
    pace = tut.sync(t0, 0.02)
    pace(0)
    pace(2)
    assert time.time() - t0 >= 0.04


def test_drone_logger_matches_jax(tmp_path):
    """The same flight logged by both: the arrays, the npz, the CSVs (grown
    past the preallocation), and the plot."""
    assert tdl.STATE_CHANNELS == jdl.STATE_CHANNELS
    assert tdl.CONTROL_CHANNELS == jdl.CONTROL_CHANNELS
    rng = np.random.default_rng(0)
    loggers = [mod.DroneLogger(logging_freq_hz=50, duration_sec=1.0, num_drones=2)
               for mod in (tdl, jdl)]
    for i in range(70):  # past the 50 preallocated columns
        state, control = rng.normal(size=12), rng.normal(size=12)
        for lg in loggers:
            lg.log(i % 2, i / 50, state, control)
    t, j = loggers
    for k in ("timestamps", "states", "controls", "counters"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    t.save_as_csv("flight", str(tmp_path / "t"))
    j.save_as_csv("flight", str(tmp_path / "j"))
    for d in range(2):
        name = f"flight_drone{d}.csv"
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    t.save(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "t.npz") as z:
        np.testing.assert_array_equal(z["states"], j.states)
    t.plot(str(tmp_path / "plot.png"))
    assert (tmp_path / "plot.png").stat().st_size > 0
