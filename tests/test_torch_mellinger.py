"""The port's Mellinger controller against the JAX package's.

- ``mellinger_control`` over a batch of random states, setpoints and
  controller states (the JAX function ``vmap``ed): the four controls within
  rtol 1e-5 and atol 1e-5 of each control's largest entry (float32: the
  attitude error is a difference of nearly equal rotations, which gains of
  7e4 scale), the new state within 1e-6;
- ``power_distribution`` and ``_motors_get_pwm`` exactly, on the same
  controls and on thrusts over the whole PWM range;
- a 200-tick ``MellingerController`` hover (500 Hz) on each package's env
  from the same start: states and actions within the JAX suite's state
  tolerance (rtol 2e-4 / atol 2e-5; atol 1e-7 N on the motor forces);
- the port's controller state from a JAX one (``utils/convert.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from safe_control_gym_torch.controllers import mellinger as tm
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.utils.convert import mellinger_state_from_numpy
from safe_control_gym_tpu.controllers import mellinger as jm
from safe_control_gym_tpu.envs import quadrotor as jq

FIELDS = ("i_error_pos", "i_error_m", "prev_omega_rp", "prev_setpoint_omega_rp")
CONTROLS = ("thrust", "roll", "pitch", "yaw")


def _inputs(B=512, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ms = {"i_error_pos": r(B, 3, scale=0.3), "i_error_m": r(B, 3, scale=0.3),
          "prev_omega_rp": r(B, 2), "prev_setpoint_omega_rp": r(B, 2)}
    args = (r(B, 3), r(B, 3, scale=0.5), r(B, 3, scale=0.3), r(B, 3, scale=2.0),
            r(B, 3), r(B, 3, scale=0.5), r(B, 3, scale=0.5), r(B, scale=0.5),
            r(B, 3, scale=0.5))
    return ms, args


def _jax_control(ms, args, kd):
    def one(ipe, iem, po, ps, *a):
        return jm.mellinger_control(jm.MellingerState(ipe, iem, po, ps), 0.002, *a,
                                    kd_omega_rp=kd)

    c, n = jax.vmap(one)(*(jnp.asarray(ms[k]) for k in FIELDS), *map(jnp.asarray, args))
    return ({k: np.asarray(v) for k, v in c.items()},
            {k: np.asarray(getattr(n, k)) for k in FIELDS})


def test_mellinger_control_matches_jax():
    ms, args = _inputs()
    for kd in (tm.KD_OMEGA_RP, 0.0):
        jc, jn = _jax_control(ms, args, kd)
        tc, tn = tm.mellinger_control(tm.MellingerState(*(torch.from_numpy(ms[k]) for k in FIELDS)),
                                      0.002, *map(torch.from_numpy, args), kd_omega_rp=kd)
        for k in CONTROLS:
            ref = jc[k]
            np.testing.assert_allclose(tc[k].numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=k)
        for k in FIELDS:
            np.testing.assert_allclose(getattr(tn, k).numpy(), jn[k], rtol=0, atol=1e-6,
                                       err_msg=k)


def test_power_distribution_and_pwm_map_exact():
    ms, args = _inputs(seed=1)
    jc, _ = _jax_control(ms, args, tm.KD_OMEGA_RP)
    want = np.asarray(jax.vmap(jm.power_distribution)({k: jnp.asarray(v) for k, v in jc.items()}))
    got = tm.power_distribution({k: torch.from_numpy(np.array(v)) for k, v in jc.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    thrust = np.linspace(0.0, tm.MAX_PWM, 4097, dtype=np.float32)
    np.testing.assert_array_equal(tm._motors_get_pwm(torch.from_numpy(thrust)).numpy(),
                                  np.asarray(jm._motors_get_pwm(jnp.asarray(thrust))))


def test_state_from_jax():
    ms, _ = _inputs(B=1)
    one = {k: v[0] for k, v in ms.items()}
    st = mellinger_state_from_numpy(one, "cpu")
    for k in FIELDS:
        got = getattr(st, k)
        assert got.shape == (1, one[k].shape[0]) and got.dtype == torch.float32
        np.testing.assert_array_equal(got[0].numpy(), one[k])


HOVER = dict(quad_type=3, task="stabilization", cost="rl_reward",
             task_info={"stabilization_goal": [0.2, -0.1, 0.8],
                        "stabilization_goal_tolerance": 0.05},
             randomized_init=False, init_state={"init_z": 0.5}, episode_len_sec=6,
             ctrl_freq=500, pyb_freq=500, done_on_out_of_bound=False)


def test_controller_hover_matches_jax():
    """200 ticks of MellingerController closed loops, each package on its own
    env from the same start (tests/test_firmware.py:67-89's setup)."""
    jenv = jq.make_quadrotor(jq.QuadrotorConfig(**HOVER))
    tenv = tq.make_quadrotor(tq.QuadrotorConfig(**HOVER), device="cpu")
    jctrl, tctrl = jm.MellingerController(jenv), tm.MellingerController(tenv)
    js, jo, _ = jax.jit(jenv.reset)(jax.random.key(0))
    ts, to, _ = tenv.reset(torch.zeros(1, dtype=torch.int32))
    step = jax.jit(jenv.step)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo))
    for k in range(200):
        ja = jctrl.select_action(np.asarray(jo))
        ta = tctrl.select_action(to[0].numpy())
        np.testing.assert_allclose(ta, np.asarray(ja), rtol=2e-4, atol=1e-7,
                                   err_msg=f"action, tick {k}")
        js, jo, _, _, _ = step(js, jnp.asarray(ja))
        ts, to, _, _, _ = tenv.step(ts, torch.from_numpy(np.asarray(ta, np.float32))[None])
        np.testing.assert_allclose(to[0].numpy(), np.asarray(jo), rtol=2e-4, atol=2e-5,
                                   err_msg=f"state, tick {k}")
    # The drone climbs toward its goal (0.5 m -> 0.8 m) in both.
    assert float(to[0, 4]) > 0.5
