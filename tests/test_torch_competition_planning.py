"""The port's competition planning stack against the JAX package's, bit for bit.

The planner, ``retime_trajectory``, the stage actions, the risk adviser,
the rate estimator, the gate corrector and the scenario pack are NumPy in
both packages; the port keeps its own copy (its ``PiecewiseTrajectory``
evaluates the times of one segment in one vectorized call, the same float64
operations element by element).  For levels 0-3, from each level's reset
state (the port's env at the level's seed):

- the planner's inputs (waypoints, limits, obstacles) and its plan, the
  retimed flight plan, a second retime with other limits, and the MPCC's
  path tables, equal.  The planner runs with one velocity-cone sample (both
  packages alike) so that the four levels take seconds; level 2 also runs
  at the competition's own search (2 iterations x 2 cone samples), the plan
  ``getting_started.run`` flies;
- ``Controller.cmdFirmware`` along a scripted flight that follows the plan
  with a wobble and reports gate sightings (measured poses off the nominal
  ones) through the info dict: every command and its arguments equal, with
  the spline racing stage and with the MPCC stage (its solve stood in by one
  host function in both packages, so the stage's own logic is compared);
- the risk adviser's decisions over tests/test_risk.py's cases, the rate
  estimator and gate corrector on the same sequences, and every scenario's
  reference and command schedule.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_torch.competition import controller as tctrl
from safe_control_gym_torch.competition import risk as trisk
from safe_control_gym_torch.competition import scenarios as tscen
from safe_control_gym_torch.competition import trajectory as ttraj
from safe_control_gym_torch.competition.getting_started import _env_config_from_level, _reset_info
from safe_control_gym_torch.competition.stage_actions import StageActionMPCC as TMPCCStage
from safe_control_gym_torch.envs.quadrotor import make_quadrotor
from safe_control_gym_torch.ops.ctr_prng import key_env_seed
from safe_control_gym_tpu.competition import controller as jctrl
from safe_control_gym_tpu.competition import risk as jrisk
from safe_control_gym_tpu.competition import scenarios as jscen
from safe_control_gym_tpu.competition import trajectory as jtraj
from safe_control_gym_tpu.competition.stage_actions import StageActionMPCC as JMPCCStage

LEVELS = os.path.join(os.path.dirname(__file__), "..", "safe_control_gym_tpu", "competition",
                      "levels")
CTRL_FREQ = 25


def _level(n):
    with open(os.path.join(LEVELS, f"level{n}.yaml")) as f:
        return yaml.safe_load(f)["quadrotor_config"]


def _start(n):
    """The level's reset observation (the port's env at the level's seed)
    and the controller's reset info."""
    level = _level(n)
    env = make_quadrotor(_env_config_from_level(level, CTRL_FREQ, CTRL_FREQ), device="cpu")
    seed = torch.full((1,), key_env_seed(int(level["seed"])), dtype=torch.int32)
    obs = env.reset(seed)[1][0].numpy()
    return obs, _reset_info(env, obs, CTRL_FREQ)


@contextlib.contextmanager
def _planner(calls, **overrides):
    """Both packages' controllers plan through a recording wrapper of their
    own planner, with ``overrides`` of its search settings."""
    saved = []
    for mod in (tctrl, jctrl):
        real = mod.plan_with_obstacle_uncertainty
        saved.append((mod, real))

        def plan(*a, _real=real, _mod=mod, **k):
            k.update(overrides)
            calls.append((_mod.__name__, a, k))
            return _real(*a, **k)

        mod.plan_with_obstacle_uncertainty = plan
    try:
        yield
    finally:
        for mod, real in saved:
            mod.plan_with_obstacle_uncertainty = real


def _build(n, use_mpcc, **overrides):
    obs, info = _start(n)
    calls = []
    with _planner(calls, **overrides):
        j = jctrl.Controller(obs, info, use_firmware=True, use_mpcc=use_mpcc)
        t = tctrl.Controller(obs, info, use_firmware=True, use_mpcc=use_mpcc, device="cpu")
    return obs, info, j, t, calls


_CACHE = {}


def _pair(n, use_mpcc):
    key = (n, use_mpcc)
    if key not in _CACHE:
        _CACHE[key] = _build(n, use_mpcc, num_cone_samples=1)
    return _CACHE[key]


def _eq(a, b, msg=""):
    """Equality of nested planner values: arrays bit for bit, objects by
    their fields."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), msg
        for x, y in zip(a, b):
            _eq(x, y, msg)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), msg
        for k in a:
            _eq(a[k], b[k], f"{msg}.{k}")
    elif hasattr(a, "__dict__") and not isinstance(a, np.ndarray):
        _eq(vars(a), vars(b), msg)
    elif hasattr(a, "_asdict"):
        _eq(a._asdict(), b._asdict(), msg)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _samples(traj, n=500):
    return traj.sample(n)


def _check_plans(j, t, calls):
    by = {name.split(".")[0]: (a, k) for name, a, k in calls}
    (ta, tk), (ja, jk) = by["safe_control_gym_torch"], by["safe_control_gym_tpu"]
    _eq(ta, ja, "planner args")
    _eq({k: v for k, v in tk.items() if k != "obstacles"},
        {k: v for k, v in jk.items() if k != "obstacles"}, "planner kwargs")
    _eq([(o.position, o.radius, o.height) for o in tk["obstacles"]],
        [(o.position, o.radius, o.height) for o in jk["obstacles"]], "obstacles")
    _eq(_samples(t.trajectory), _samples(j.trajectory), "plan")
    _eq(_samples(t.flight_traj), _samples(j.flight_traj), "retimed plan")


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_planner_and_retime_match_jax(n):
    obs, info, j, t, calls = _pair(n, use_mpcc=False)
    _check_plans(j, t, calls)
    gates = [np.array([g[0], g[1], 1.0 if int(g[6]) == 0 else 0.525])
             for g in info["nominal_gates_pos_and_type"]]
    kw = dict(gate_centers=gates, v_max=1.5, v_gate=0.4, a_max=2.0, v_first=0.8)
    _eq(_samples(ttraj.retime_trajectory(t.trajectory, **kw)),
        _samples(jtraj.retime_trajectory(j.trajectory, **kw)), "retime")


def test_full_search_plan_level2_matches_jax():
    """Level 2 at the planner settings the competition controller flies
    (max_iterations=2, num_cone_samples=2), and the MPCC's path tables."""
    obs, info, j, t, calls = _build(2, use_mpcc=True)
    _check_plans(j, t, calls)
    jm = next(s.mpcc for s in j.sequencer.stages if isinstance(s, JMPCCStage))
    tm = next(s.mpcc for s in t.sequencer.stages if isinstance(s, TMPCCStage))
    for name in ("theta_grid", "path_pos", "path_tan", "path_vel", "path_speed", "contour_w",
                 "gate_thetas", "gate_positions", "frames0"):
        np.testing.assert_array_equal(getattr(tm, name), np.asarray(getattr(jm, name)),
                                      err_msg=name)
    assert tm.theta_max == jm.theta_max


def _fake_solve(mpcc):
    """A host stand-in for an MPCC solve, the same in both packages: progress
    advances at 1.1 plan-seconds a second, the state is the observation."""
    def solve(obs, theta, theta_dot, rbf=None, frames=None, bands=None):
        th = min(float(theta) + 1.1 / CTRL_FREQ, mpcc.theta_max)
        x = np.zeros(18)
        x[:12] = obs[:12]
        x[16], x[17] = th, 1.1
        return x, np.stack([x] * (mpcc.T + 1)), th, 1.1

    return solve


def _flight(ctrl, info0, steps=1600):
    """Drive ``cmdFirmware`` along a scripted flight: climb 2 s, then follow
    the flight plan with a wobble; gate sightings in range of the current
    gate report its pose moved by (0.06, -0.05, yaw 0.04).  Returns the
    commands with their arguments."""
    gates = [np.asarray(g, float) for g in info0["nominal_gates_pos_and_type"]]
    heights = {0: 1.0, 1: 0.525}
    traj = ctrl.flight_traj
    out, gate, reward, done = [], 0, 0.0, False
    start = np.array([ctrl.initial_obs[0], ctrl.initial_obs[2], ctrl.initial_obs[4]])
    for it in range(steps):
        t = it / CTRL_FREQ
        if t < 2.0:
            pos = start + np.array([0.0, 0.0, (1.0 - start[2]) * t / 2.0])
            vel = np.array([0.0, 0.0, (1.0 - start[2]) / 2.0])
        else:
            tau = min(traj.start_time + t - 2.0, traj.end_time)
            pos = traj.position(tau).reshape(-1)[:3] + 0.03 * np.sin([0.7 * it, 1.1 * it, 0.5 * it])
            vel = traj.velocity(tau).reshape(-1)[:3]
        rpy = 0.02 * np.sin([0.3 * it, 0.5 * it, 0.0])
        obs = np.array([pos[0], vel[0], pos[1], vel[1], pos[2], vel[2], *rpy, 0.0, 0.0, 0.0])
        info = {}
        if gate < len(gates):
            g = gates[gate]
            gz = heights[int(g[6])]
            in_range = bool(np.linalg.norm(pos - np.array([g[0], g[1], gz])) < 0.9)
            pose = [g[0] + 0.06, g[1] - 0.05, gz, 0.0, 0.0, g[5] + 0.04] if in_range \
                else [g[0], g[1], gz, 0.0, 0.0, g[5]]
            info = {"current_target_gate_id": gate, "current_target_gate_type": int(g[6]),
                    "current_target_gate_in_range": in_range, "current_target_gate_pos": pose}
            if np.linalg.norm(pos - np.array([g[0], g[1], gz])) < 0.15:
                gate += 1
        else:
            info = {"current_target_gate_id": -1, "current_target_gate_type": -1,
                    "current_target_gate_in_range": False,
                    "current_target_gate_pos": [0.0] * 6}
        command, args = ctrl.cmdFirmware(t, obs, reward, done, info)
        out.append((command.name, args))
        if command.name == "FINISHED":
            break
    return out


@pytest.mark.parametrize("use_mpcc", [False, True], ids=["spline", "mpcc"])
@pytest.mark.parametrize("n", [0, 2, 3])
def test_stage_actions_match_jax_along_a_scripted_flight(n, use_mpcc):
    obs, info, j, t, _ = _pair(n, use_mpcc)
    if use_mpcc:
        for ctrl, cls in ((j, JMPCCStage), (t, TMPCCStage)):
            for st in ctrl.sequencer.stages:
                if isinstance(st, cls):
                    st.mpcc.solve = _fake_solve(st.mpcc)
    for ctrl in (j, t):
        ctrl.reset()
    jc, tc = _flight(j, info), _flight(t, info)
    assert len(jc) == len(tc)
    names = {c for c, _ in tc}
    assert {"TAKEOFF", "FULLSTATE", "GOTO", "LAND"} <= names, names
    for k, ((jn, ja), (tn, ta)) in enumerate(zip(jc, tc)):
        assert jn == tn, (k, jn, tn)
        _eq(ta, ja, f"step {k} {tn}")


G1 = {1: [1, 2, 3, 0, 0, 0, 0], 2: [1, 2, 3, 0, 0, 0, 0], 3: [1, 2, 3, 0, 0, 0, 0]}
G2 = {1: [1, 2, 3, 0, 0, 0, 0], 2: [1, 2.01, 3, 0, 0, 0, 0], 3: [1, 2, 3, 0, 0, 0, 0]}
G3 = {1: [1, 2, 3, 0, 0, 0, 0], 2: [1, 2, 3, 0, 0, 0, 0], 3: [1, 2, 3.01, 0, 0, 0, 0]}
G4 = {1: [1, 2, 3, 0, 0, 0, 0], 2: [1, 2, 3, 0, 0, 0, 0], 3: [1, 2, 3, 0, 0, 0, 0]}
RISK_CASES = {  # tests/test_risk.py:58-103
    "vanilla_level0": ([(True, G1, G1)] * 4, False),
    "level0_all_crashes": ([(False, G1, G1)] * 4, False),
    "level2_static_offsets": ([(True, G1, G2)] * 4, False),
    "level2_crash_on_ep3": ([(True, G1, G2), (True, G1, G2), (False, G1, G2), (True, G1, G2)],
                            False),
    "level3_randomized": ([(True, G1, G2), (True, G1, G3), (True, G1, G4), (True, G1, G3)], False),
    "forced_conservative": ([(True, G1, G2)] * 8, True),
    "too_many_episodes": ([(True, G1, G1)] * 6, False),
}


def _advice(mod, results, forced):
    adviser = mod.RiskAdviser(forced_conservative_mode=forced)
    out = []
    for r in results:
        profile, hint = adviser.episode_advice()
        out.append((profile.name, hint))
        adviser.episode_results(*r)
    return out


@pytest.mark.parametrize("case", sorted(RISK_CASES))
def test_risk_adviser_matches_jax(case):
    results, forced = RISK_CASES[case]
    tr, jr = _advice(trisk, results, forced), _advice(jrisk, results, forced)
    assert [p for p, _ in tr] == [p for p, _ in jr]
    _eq([h for _, h in tr], [h for _, h in jr], case)
    gates = [G1, G2, G3, G4, {}]
    for a in gates:
        for b in gates:
            assert trisk.gate_data_close(a, b) is jrisk.gate_data_close(a, b)


def test_rate_estimator_and_gate_corrector_match_jax():
    rng = np.random.default_rng(0)
    for enabled in (False, True):
        te, je = trisk.RateEstimator(0.04, enabled), jrisk.RateEstimator(0.04, enabled)
        for k in range(50):
            pos, rpy = rng.standard_normal(3), rng.standard_normal(3) * 0.2
            _eq(te.estimate(pos, rpy), je.estimate(pos, rpy), f"estimate {k}")
            if k == 25:
                te.reset()
                je.reset()
    tg, jg = trisk.GateCorrector({0: 1.0, 1: 0.525}), jrisk.GateCorrector({0: 1.0, 1: 0.525})
    seq = [{}] + [{"current_target_gate_id": k // 6, "current_target_gate_type": (k // 6) % 2,
                   "current_target_gate_in_range": k % 6 > 2,
                   "current_target_gate_pos": [k * 0.1, 1.0 - 0.05 * k, 0, 0, 0, 0.1 * k]}
                  for k in range(24)] + [{"current_target_gate_id": -1}]
    for k, info in enumerate(seq):
        _eq(tg.update(info), jg.update(info), f"update {k}")
    _eq(tg.nominal, jg.nominal)
    _eq(tg.exact, jg.exact)


@pytest.mark.parametrize("name", sorted(jscen.SCENARIOS))
def test_scenario_matches_jax(name):
    assert sorted(tscen.SCENARIOS) == sorted(jscen.SCENARIOS)
    for freq in (30, 50):
        _eq(tscen.make_scenario(name).generate(freq), jscen.make_scenario(name).generate(freq))
    tc, jc = tscen.ScenarioController(name, 30), jscen.ScenarioController(name, 30)
    _eq(tc.reference(), jc.reference())
    length = jc.scenario.trajectory_length
    for it in range(int((length + 9) * 30)):
        (tn, ta), (jn, ja) = tc.cmdFirmware(it / 30), jc.cmdFirmware(it / 30)
        assert tn.name == jn.name, it
        _eq(ta, ja, f"{name} step {it}")
