"""The port's Crazyflie firmware emulator against the JAX package's.

- ``Lpf2p``, ``_poly7_nojerk`` and ``_poly_eval`` exactly;
- the per-tick setpoints (``_setpoints_for``) after every command: takeoff
  (with and without yaw), goto absolute and relative, land (with and
  without yaw), stop, notify-stop and full state, exactly;
- the port's host loop against the JAX package's host loop over 25 control
  steps of takeoff (tests/test_firmware.py:16-30's env): observations and
  actions within atol 1e-5 (measured: ~1e-7), done equal, ticks equal;
- the port's fused block against its own host loop over
  tests/test_firmware.py:175-202's script (takeoff, a goto at control step
  25, 60 steps): bit for bit on the CPU (the JAX suite holds its pair at
  2e-2), and with the action and sensor delays within 1e-3;
- one fused block from the JAX wrapper's carry (``utils/convert.py``)
  against the JAX fused block: the JAX suite's state tolerance, rtol 2e-4 /
  atol 2e-5;
- the delay buffers, the tumble kill, stop killing the motors, and
  ``STATE_DELAY`` raising; K1 once a firmware tick (a counting stand-in on
  the CPU); and the fused block making no host-device synchronization by its
  operations (no tensor made from host data, no value read back), the CPU
  rehearsal of chip_smoke.py's ``set_sync_debug_mode("error")`` check.
"""

import jax
import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from safe_control_gym_torch.controllers import firmware as tf
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.ops import quad_substeps
from safe_control_gym_torch.utils.convert import firmware_carry_from_numpy
from safe_control_gym_tpu.controllers import firmware as jf
from safe_control_gym_tpu.envs import quadrotor as jq


def _cfg(**kw):
    cfg = dict(quad_type=3, task="stabilization", cost="rl_reward",
               task_info={"stabilization_goal": [0, 0, 1], "stabilization_goal_tolerance": 0.05},
               randomized_init=False, init_state={"init_z": 0.03}, episode_len_sec=6,
               ctrl_freq=500, pyb_freq=500, done_on_out_of_bound=False)
    cfg.update(kw)
    return cfg


def _port(fused, **kw):
    wkw = {k: kw.pop(k) for k in ("action_delay", "sensor_delay") if k in kw}
    return tf.FirmwareWrapper(tq.make_quadrotor(tq.QuadrotorConfig(**_cfg(**kw)), device="cpu"),
                              500, 25, fused=fused, **wkw)


def _jax(fused, **kw):
    return jf.FirmwareWrapper(lambda: jq.make_quadrotor(jq.QuadrotorConfig(**_cfg(**kw))),
                              500, 25, fused=fused)


def test_lpf2p_and_poly7_exact():
    for fs, fc in ((500.0, 30.0), (500.0, 80.0), (250.0, 30.0)):
        a, b = tf.Lpf2p(fs, fc), jf.Lpf2p(fs, fc)
        for v in np.sin(np.arange(200) * 0.37) * 3.0:
            assert a.apply(float(v)) == b.apply(float(v))
    for args in ((2.5, 0.2, 0.4, -0.3, 1.5, 0.0, 0.0), (1e-9, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0),
                 (1.7, -1.0, 0.3, 2.0, 0.25, 0.1, -0.2)):
        c = tf._poly7_nojerk(*args)
        np.testing.assert_array_equal(c, jf._poly7_nojerk(*args))
        for t in (0.0, 0.3, args[0], 2.0):
            assert tf._poly_eval(c, t) == jf._poly_eval(c, t)


COMMANDS = (("sendTakeoffCmd", (1.0, 2.0)), ("sendGotoCmd", ([0.4, -0.2, 1.1], 0.3, 1.5, False)),
            ("sendGotoCmd", ([0.1, 0.2, -0.1], 0.0, 0.8, True)), ("sendLandCmd", (0.1, 2.0)),
            ("sendTakeoffYawCmd", (0.9, 1.0, 0.5)), ("sendLandYawCmd", (0.2, 1.2, -0.4)),
            ("sendNotifySetpointStop", ()), ("sendStopCmd", ()),
            ("sendFullStateCmd", ([0.2, -0.2, 0.8], [0.1, 0.0, 0.0], [0.0, 0.0, 0.1], 0.2,
                                  [0.0, 0.0, 0.3], 0.0)))


def test_setpoints_of_every_command_match_jax():
    """Each command popped at a control step, then the block's per-tick
    setpoints at three points of its plan (start, middle, past the end),
    exactly as the JAX package's; the setpoint carried on as a fused step
    carries it."""
    tw, jw = _port(True), _jax(True)
    tw.reset(seed=1)
    jw.reset(seed=1)
    t = 0.0
    for name, args in COMMANDS:
        for w in (tw, jw):
            getattr(w, name)(*args)
            w._process_command_queue(t)
        for k0 in (int(t * 500), int(t * 500) + 250, int(t * 500) + 1500):
            ticks = list(range(k0, k0 + 20))
            sp_t, act_t = tw._setpoints_for(ticks)
            sp_j, act_j = jw._setpoints_for(ticks)
            assert act_t == act_j, name
            for key in sp_j:
                np.testing.assert_array_equal(sp_t[key], sp_j[key], err_msg=f"{name} {key}")
        for w, sp in ((tw, sp_t), (jw, sp_j)):
            if act_t:
                w.setpoint = {k: (float(v[-1]) if k == "yaw" else v[-1]) for k, v in sp.items()}
        assert tw.full_state_cmd_override == jw.full_state_cmd_override
        t += 1.0


def test_host_loop_matches_jax_host_loop():
    tw, jw = _port(False), _jax(False)
    to, _ = tw.reset(seed=3)
    jo, _ = jw.reset(seed=3)
    np.testing.assert_array_equal(to, np.asarray(jo))
    for w in (tw, jw):
        w.sendTakeoffCmd(1.0, 2.0)
    ta = ja = np.zeros(4)
    for i in range(25):
        to, tr, td, ti, ta = tw.step(i / 25, ta)
        jo, jr, jd, ji, ja = jw.step(i / 25, ja)
        np.testing.assert_allclose(to, np.asarray(jo), rtol=0, atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(ta, np.asarray(ja), rtol=0, atol=1e-5, err_msg=f"step {i}")
        assert td == bool(jd) and abs(tr - float(jr)) < 1e-5 and tw.tick == jw.tick
    assert to[4] > 0.3  # climbing
    assert set(ji) <= set(ti)


def _script(fwf, fwh, steps=60):
    """tests/test_firmware.py:175-202's script on two wrappers; yields each
    control step's outputs of both."""
    for fw in (fwf, fwh):
        fw.reset(seed=3)
        fw.sendTakeoffCmd(1.0, 2.0)
    af = ah = np.zeros(4)
    for i in range(steps):
        if i == 25:
            for fw in (fwf, fwh):
                fw.sendGotoCmd([0.4, -0.2, 1.1], 0.0, 1.5, relative=False)
        of, rf, df, inf_f, af = fwf.step(i / 25, af)
        oh, rh, dh, inf_h, ah = fwh.step(i / 25, ah)
        yield i, (of, rf, df, inf_f, af), (oh, rh, dh, inf_h, ah)


@pytest.mark.parametrize("delays", [{}, {"action_delay": 3, "sensor_delay": 2}],
                         ids=["no_delay", "delays"])
def test_fused_matches_host_loop(delays):
    """Bit for bit without delays.  With a sensor delay the host loop's
    zero-initialized history (float64 zeros) puts its gyro filter in float64
    while the fused block's stays float32: atol 1e-3 there (measured
    1.9e-4 on the observations over the 60 steps; the JAX suite: 2e-2)."""
    fwf, fwh = _port(True, **delays), _port(False, **delays)
    atol = 1e-3 if delays else 0.0
    for i, f, h in _script(fwf, fwh):
        np.testing.assert_allclose(f[0], h[0], rtol=0, atol=atol, err_msg=f"obs, step {i}")
        np.testing.assert_allclose(f[4], h[4], rtol=0, atol=atol, err_msg=f"action, step {i}")
        assert abs(f[1] - h[1]) <= atol and f[2] == h[2] and fwf.tick == fwh.tick
        assert fwf._error == fwh._error
    for key in h[3]:
        np.testing.assert_allclose(np.asarray(f[3][key]), np.asarray(h[3][key]), rtol=0,
                                   atol=atol, err_msg=key)
    if not delays:
        pos = np.array([f[0][0], f[0][2], f[0][4]])
        assert np.linalg.norm(pos - np.array([0.4, -0.2, 1.1])) < 0.15, pos


def _jax_carry(jw):
    """The JAX wrapper's fused carry with NumPy leaves."""
    c = dict(jw._carry)
    es = c.pop("env_state")
    ms = c.pop("ms")
    out = jax.tree.map(np.asarray, c)
    out["env_state"] = jax.tree.map(np.asarray, {k: getattr(es, k) for k in es.__dataclass_fields__
                                                 if k != "key"})
    out["ms"] = {k: np.asarray(getattr(ms, k)) for k in ms.__dataclass_fields__}
    return out


HOST_FIELDS = ("tick", "pwms", "action", "_error", "full_state_cmd_override", "setpoint", "_plan",
               "last_att_pid_call", "last_pos_pid_call")


def test_fused_block_from_jax_carry():
    """30 control steps of the JAX fused block (takeoff), then its carry and
    host state into the port's wrapper; the next block in both."""
    jw, tw = _jax(True), _port(True)
    jw.reset(seed=3)
    tw.reset(seed=3)
    jw.sendTakeoffCmd(1.0, 2.0)
    a = np.zeros(4)
    for i in range(30):
        _, _, _, _, a = jw.step(i / 25, a)
    tw._carry = firmware_carry_from_numpy(_jax_carry(jw), "cpu")
    for name in HOST_FIELDS:
        setattr(tw, name, getattr(jw, name))
    for w in (jw, tw):
        w.sendGotoCmd([0.3, 0.1, 1.0], 0.0, 1.0, relative=False)
    jo, jr, jd, _, ja = jw.step(30 / 25, a)
    to, tr, td, _, ta = tw.step(30 / 25, a)
    np.testing.assert_allclose(to, np.asarray(jo), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ta, np.asarray(ja), rtol=2e-4, atol=2e-5)
    assert td == bool(jd) and tw.tick == jw.tick and abs(tr - float(jr)) < 1e-5
    np.testing.assert_allclose(tw.pwms, np.asarray(jw.pwms), rtol=2e-4, atol=1e-2)


def test_action_delay_buffer():
    """ACTION_DELAY shifts the motor response by k firmware loops
    (tests/test_firmware.py:125-144)."""
    fw0, fwd = _port(True), _port(True, action_delay=3)
    for fw in (fw0, fwd):
        fw.reset()
        fw.sendTakeoffCmd(1.0, 2.0)
    a0 = fw0.step(0.0, np.zeros(4))[-1]
    ad = fwd.step(0.0, np.zeros(4))[-1]
    assert a0.sum() > 0 and fwd.ACTION_DELAY == 3 and len(fwd.action_history) == 3
    assert fwd._carry["ahist"].shape == (1, 3, 4)
    for i in range(1, 10):
        ad = fwd.step(i / 25, ad)[-1]
    assert ad.sum() > 0


def test_sensor_delay_hovers():
    """SENSOR_DELAY feeds the controller measurements from k loops ago
    (tests/test_firmware.py:147-158): a delay of 2 still takes off."""
    fw = _port(True, sensor_delay=2)
    obs, _ = fw.reset()
    assert len(fw.sensor_history) == 2 and fw._carry["shist"].shape == (1, 2, 2, 3)
    fw.sendTakeoffCmd(1.0, 2.0)
    action = np.zeros(4)
    for i in range(75):
        obs, r, d, info, action = fw.step(i / 25, action)
    assert abs(obs[4] - 1.0) < 0.15, obs[4]


def test_tumble_kill():
    """An upside-down drone under thrust reads its world z acceleration below
    -0.5 g tick after tick: at the 30th the motors are killed, the action is
    zero and the step ends done, at the same tick in both loops."""
    ticks = []
    for fused in (True, False):
        fw = _port(fused, init_state={"init_z": 1.5, "init_phi": 3.0})
        fw.reset()
        fw.sendFullStateCmd([0.0, 0.0, 1.5], np.zeros(3), np.zeros(3), 0.0, np.zeros(3), 0.0)
        action, done, step = np.full(4, 0.08), False, 0
        while not done and step < 4:
            obs, r, done, info, action = fw.step(step / 25, action)
            step += 1
        assert fw._error and done and np.all(action == 0.0) and np.all(fw.pwms == 0.0)
        ticks.append(fw.tick)
    assert ticks[0] == ticks[1] and 30 <= ticks[0] < 40, ticks


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_stop_kills_motors(fused):
    fw = _port(fused, init_state={"init_z": 1.0})
    fw.reset()
    fw.sendStopCmd()
    obs, r, d, info, action = fw.step(0.0, np.zeros(4))
    assert np.allclose(action, 0.0) and d


def test_state_delay_unsupported():
    class _D(tf.FirmwareWrapper):
        STATE_DELAY = 1

    with pytest.raises(NotImplementedError):
        _D(tq.make_quadrotor(tq.QuadrotorConfig(**_cfg()), device="cpu"), 500, 25)


def test_k1_once_a_tick(monkeypatch):
    """K1's wrapper once per firmware tick: 20 per control step at 25 Hz
    (a counting stand-in around the plain version, the CPU's path)."""
    calls = []

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return quad_substeps.quad3d_substeps_plain(*a, **k)

    monkeypatch.setattr(tq, "quad3d_substeps", counting)
    fw = _port(True)
    fw.reset()
    fw.sendTakeoffCmd(1.0, 2.0)
    a = np.zeros(4)
    for i in range(3):
        calls.clear()
        _, _, _, _, a = fw.step(i / 25, a)
        assert len(calls) == 20 and set(calls) == {1}


HOST_DATA_OPS = {"lift_fresh", "_local_scalar_dense", "nonzero", "is_nonzero", "equal", "item",
                 "masked_select", "unique", "_unique2", "bincount"}


class _SyncAudit(TorchDispatchMode):
    """Records the operations that on a card would copy host data to the
    device or read a value back (each a host-device synchronization)."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_DATA_OPS or (name == "_to_copy" and "device" in (kwargs or {})):
            self.hits.append(str(func))
        return func(*args, **(kwargs or {}))


def test_fused_block_makes_no_sync_by_its_ops():
    """The device part of a fused control step (``_launch_block``; its one input
    copy is pinned and asynchronous on a card) makes no operation that synchronizes: on a level-2 competition env (gates,
    obstacles, the noise channels), two blocks of a takeoff."""
    import os

    import yaml

    from safe_control_gym_torch.competition.getting_started import _env_config_from_level

    levels = os.path.join(os.path.dirname(__file__), "..", "safe_control_gym_tpu", "competition",
                          "levels")
    with open(os.path.join(levels, "level2.yaml")) as f:
        level = yaml.safe_load(f)["quadrotor_config"]
    env = tq.make_quadrotor(_env_config_from_level(level, 500, 500), device="cpu")
    fw = tf.FirmwareWrapper(env, 500, 25, fused=True, kd_omega_rp=0.0)
    fw.reset(seed=2)
    fw.sendTakeoffCmd(1.0, 2.0)
    a = np.asarray(env.spaces.action_low, np.float64)
    _, _, _, _, a = fw.step(0.0, a)
    for i in (1, 2):
        ticks, run_ctrl, gate_after, sp_seq, plan_active = fw._plan_block(i / 25)
        inputs = fw._block_inputs(run_ctrl, sp_seq, a)
        with _SyncAudit() as audit:
            out = fw._launch_block(*inputs)
        assert audit.hits == [], audit.hits
        _, _, _, _, a = fw._read_block(out, gate_after, sp_seq, plan_active)
