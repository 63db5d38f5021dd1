"""The port's competition main loop (``getting_started.run``) against the
JAX package's, on the CPU.

- the level-2 course of seed 2: the port's reset draws (gate and obstacle
  poses, mass, inertia, initial state) equal to the JAX package's un-jitted
  ``reset(jax.random.key(2))`` bit for bit, through ``run``'s sim-only path
  and through ``FirmwareWrapper.reset``;
- level 0 on the sim-only path (PID, ``ctrl_freq=60``): the bar of
  tests/test_competition.py:116-125 (4 gates, 0 collisions, reward > 300),
  and its first 60 steps against the JAX package's ``run``: observations
  within atol 1e-3 (measured 2.8e-4: the float32 PID closed loop doubles a
  last-place difference every few steps) and actions within 2e-4 of their
  largest entry (measured 3.5e-5);
- level 2 on the sim-only path, seed 2: the episode runs past 60 steps
  (tests/test_competition.py:128-143);
- ``dispatch_command`` for every ``Command`` against the JAX package's;
  ``thrusts``, ``plot_trajectory`` and ``draw_trajectory``
  (tests/test_competition.py:164-191); the entry point runs on CUDA
  unless given ``device="cpu"`` and raises without a card.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_torch.competition import competition_utils as tcu
from safe_control_gym_torch.competition import getting_started as tg
from safe_control_gym_torch.competition.controller import Controller as TController
from safe_control_gym_torch.controllers.firmware import FirmwareWrapper
from safe_control_gym_torch.envs.quadrotor import make_quadrotor
from safe_control_gym_torch.ops.ctr_prng import key_env_seed
from safe_control_gym_tpu.competition import competition_utils as jcu
from safe_control_gym_tpu.competition import getting_started as jg
from safe_control_gym_tpu.competition.controller import Controller as JController
from safe_control_gym_tpu.envs import quadrotor as jq

LEVELS = os.path.join(os.path.dirname(__file__), "..", "safe_control_gym_tpu", "competition",
                      "levels")
DRAWS = ("x", "mass", "j_diag", "gates_eff", "obstacles_eff", "env_seed")


def _level(n, **kw):
    with open(os.path.join(LEVELS, f"level{n}.yaml")) as f:
        level = yaml.safe_load(f)["quadrotor_config"]
    level.update(kw)
    return level


def test_level2_seed2_course_draws_match_jax():
    level = _level(2, seed=2)
    jenv = jq.make_quadrotor(jg._env_config_from_level(level, 60, 60))
    js, jo, _ = jenv.reset(jax.random.key(2))
    want = {k: np.asarray(getattr(js, k)) for k in DRAWS}
    tenv = make_quadrotor(tg._env_config_from_level(level, 60, 60), device="cpu")
    seeds = torch.full((1,), key_env_seed(2), dtype=torch.int32)
    ts, to, _ = tenv.reset(seeds)
    fw = FirmwareWrapper(make_quadrotor(tg._env_config_from_level(level, 500, 500), device="cpu"),
                         500, 25, fused=True)
    fo, _ = fw.reset(seed=2)
    for state in (ts, fw.env_state):
        for k in DRAWS:
            np.testing.assert_array_equal(getattr(state, k)[0].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo))
    np.testing.assert_array_equal(fo, np.asarray(jo))
    # The draws moved the course off its nominal poses.
    assert np.abs(want["gates_eff"][:, :2] - np.asarray(level["gates"])[:, :2]).max() > 0.01


def _recorder(base):
    class Recording(base):
        log = []

        def cmdSimOnly(self, t, obs, *a, **k):
            act = super().cmdSimOnly(t, obs, *a, **k)
            type(self).log.append((np.array(obs, np.float64), np.array(act, np.float64)))
            return act

    return Recording


def test_level0_sim_only_completes_course_and_follows_jax():
    rt = _recorder(TController)
    ep = tg.run(_level(0), num_episodes=1, use_firmware=False, ctrl_freq=60, controller_cls=rt,
                device="cpu")[0]
    assert ep["collisions"] == 0, ep
    assert ep["gates_passed"] == 4, ep
    assert ep["reward"] > 300, ep
    rj = _recorder(JController)
    jg.run(_level(0, episode_len_sec=1.0), num_episodes=1, use_firmware=False, ctrl_freq=60,
           controller_cls=rj)
    assert len(rj.log) == 60
    scale = max(np.abs(a).max() for _, a in rj.log)
    for k, ((jo, ja), (to, ta)) in enumerate(zip(rj.log, rt.log)):
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-3, err_msg=f"obs, step {k}")
        np.testing.assert_allclose(ta, ja, rtol=0, atol=2e-4 * scale, err_msg=f"action, step {k}")


def test_level2_sim_only_randomized_runs():
    eps = tg.run(_level(2, seed=2), num_episodes=1, use_firmware=False, ctrl_freq=60,
                 device="cpu")
    assert eps[0]["steps"] > 60, eps


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("send"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args))


COMMAND_ARGS = {
    "FULLSTATE": [(np.ones(3), np.zeros(3), np.zeros(3), 0.1, np.zeros(3)),
                  (np.ones(3), np.zeros(3), np.zeros(3), 0.1, np.zeros(3), 2.0)],
    "TAKEOFF": [(1.0, 2.0)], "LAND": [(0.05, 2.0)], "STOP": [()],
    "GOTO": [([0.1, 0.2, 1.0], 0.0, 1.5, False)], "NOTIFYSETPOINTSTOP": [()],
    "NONE": [()], "FINISHED": [()],
}


def test_dispatch_command_matches_jax():
    assert [c.name for c in tcu.Command] == [c.name for c in jcu.Command]
    assert [c.value for c in tcu.Command] == [c.value for c in jcu.Command]
    for name, cases in COMMAND_ARGS.items():
        for args in cases:
            tw, jw = _Recorder(), _Recorder()
            tcu.dispatch_command(tw, tcu.Command[name], args, t=1.5)
            jcu.dispatch_command(jw, jcu.Command[name], args, t=1.5)
            assert [c for c, _ in tw.calls] == [c for c, _ in jw.calls], name
            for (_, ta), (_, ja) in zip(tw.calls, jw.calls):
                assert len(ta) == len(ja)
                for a, b in zip(ta, ja):
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        tcu.dispatch_command(_Recorder(), "BOGUS", ())


def test_competition_utils_plot_draw_thrusts(tmp_path):
    t = np.linspace(0, 4, 50)
    rx, ry, rz = np.sin(t), np.cos(t), 1 + 0.1 * t
    wps = np.stack([rx[::10], ry[::10], rz[::10]], -1)
    paths = tcu.plot_trajectory(t, wps, rx, ry, rz, out_path=str(tmp_path / "traj.png"))
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    info = {"nominal_gates_pos_and_type": [[0.5, -1.0, 0, 0, 0, 0.8, 0]],
            "nominal_obstacles_pos": [[1.5, 0, 0, 0, 0, 0]]}
    frame = tcu.draw_trajectory(info, wps, rx, ry, rz, out_path=str(tmp_path / "plan.png"))
    assert frame.shape[-1] == 3 and os.path.exists(tmp_path / "plan.png")
    tc, jc = types.SimpleNamespace(), types.SimpleNamespace()
    obs = np.zeros(12)
    obs[4] = 1.0
    for k in range(3):
        obs[0] = 0.05 * k
        tf = tcu.thrusts(tc, 1 / 30, 3.16e-10, obs, np.array([0, 0, 1.2]), np.zeros(3),
                         device="cpu")
        jf = jcu.thrusts(jc, 1 / 30, 3.16e-10, obs, np.array([0, 0, 1.2]), np.zeros(3))
        assert tf.shape == (4,) and np.all(tf > 0)
        np.testing.assert_allclose(tf, jf, rtol=2e-4)
    assert tc.pid_state.integral_pos_e.shape == (1, 3)  # carried for the next call


def test_gui_raises_and_device_default():
    """The entry point runs on CUDA unless given ``device="cpu"`` and raises
    without a card.  (``gui=True`` raised here until the viewer was ported;
    tests/test_torch_viewer.py now flies it.)"""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tg.run(_level(0), use_firmware=False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TController(np.zeros(12), {"ctrl_freq": 25, "ctrl_timestep": 0.04})
