"""The port's batched 3D quadrotor env against ``jax.vmap`` of the JAX
package's env (XLA path, ``use_pallas=False``) on BASELINE config 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import gates as tg
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.utils.convert import quad_state_from_numpy
from safe_control_gym_tpu.envs import gates as jg
from safe_control_gym_tpu.envs import quadrotor as jq

B = 128

# BASELINE config 4 (bench.py build()).
CFG4 = dict(
    quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=6,
    task="traj_tracking",
    task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
               "trajectory_position_offset": [0.0, 0.0], "trajectory_scale": 1.0,
               "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
    cost="rl_reward", randomized_inertial_prop=True, randomized_init=True,
    constraints=({"constraint_form": "default_constraint", "constrained_variable": "state"},
                 {"constraint_form": "default_constraint", "constrained_variable": "input"}),
    disturbances={"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.005,
                                "duration": 10, "decay_rate": 0.8},)},
    done_on_out_of_bound=True,
)


def _envs(**kw):
    cfg = {**CFG4, **kw}
    jenv = jq.make_quadrotor(jq.QuadrotorConfig(**cfg, use_pallas=False))
    tenv = tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu")
    return jenv, tenv


def _actions(hover, steps, seed=0):
    """Thrusts around hover; a few envs command 0 or 0.2 N, outside the
    action box, to exercise the clip and the input-constraint rows."""
    rng = np.random.default_rng(seed)
    a = hover * (1.0 + 0.2 * rng.uniform(-1, 1, (steps, B, 4)))
    a[:, :4] = 0.0
    a[:, 4:8] = 0.2
    return a.astype(np.float32)


_VARIANTS = {
    "config4": {},
    "time_limit": dict(episode_len_sec=0.05),
    "euler_step_disturbances": dict(physics="dyn", disturbances={
        "action": ({"disturbance_func": "step", "magnitude": 0.01, "step_offset": 2},),
        "observation": ({"disturbance_func": "impulse", "magnitude": 0.1, "step_offset": 1,
                         "duration": 3, "decay_rate": 0.5, "mask": [1] * 6 + [0] * 6},),
        "dynamics": CFG4["disturbances"]["dynamics"]}),
    "stabilization_quadratic": dict(
        task="stabilization", cost="quadratic",
        task_info={"stabilization_goal": [0, 0, 1], "stabilization_goal_tolerance": 0.05},
        q_weight=[2.0, 0.1, 2.0, 0.1, 5.0, 0.1, 1, 1, 1, 0.2, 0.2, 0.2], r_weight=[0.5]),
    "normalized_goal_horizon": dict(normalized_rl_action_space=True, obs_goal_horizon=2),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_reset_and_steps_match_jax(variant):
    kw = _VARIANTS[variant]
    episode_len_sec = kw.get("episode_len_sec", 6)
    jenv, tenv = _envs(**kw)
    keys = jax.random.split(jax.random.key(0), B)
    js, jo, jinfo = jax.vmap(jenv.reset)(keys)
    ts, to, tinfo = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    # Identical counter draws; the affine map may differ by XLA's FMA
    # contraction (1 ulp).
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=2e-7)
    np.testing.assert_allclose(ts.mass.numpy(), np.asarray(js.mass), rtol=1e-6)
    np.testing.assert_array_equal(
        ts.dist_offsets["dynamics"].numpy(), np.asarray(js.dist_sched["dynamics"]["offsets"]))
    np.testing.assert_allclose(tinfo["constraint_values_state"].numpy(),
                               np.asarray(jinfo["constraint_values_state"]), atol=2e-7)

    # Normalized actions live in [-1, 1]: centre them on 1 so that half clip.
    acts = _actions(1.0 if kw.get("normalized_rl_action_space") else float(jenv.u_goal[0]), 5)
    jstep = jax.jit(jax.vmap(jenv.step))
    for a in acts:
        js, jo, jr, jd, ji = jstep(js, jnp.asarray(a))
        ts, to, tr, td, ti = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=5e-6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for k in ("constraint_violation", "TimeLimit.truncated", "collision",
                  "at_goal_position", "task_completed", "current_target_gate_id"):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
        np.testing.assert_allclose(ti["mse"].numpy(), np.asarray(ji["mse"]),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(ti["constraint_values"].numpy(),
                                   np.asarray(ji["constraint_values"]), rtol=2e-4, atol=2e-5)
    assert np.asarray(ji["constraint_violation"]).sum() > 0  # the clipped envs
    if episode_len_sec < 1:
        assert np.asarray(ji["TimeLimit.truncated"]).any()


def test_convert_carries_jax_state():
    """utils/convert: a JAX state carried across steps identically to the
    port's own reset of the same seeds."""
    jenv, tenv = _envs()
    js, _, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(5), B))
    fields = jax.tree.map(np.asarray, {k: getattr(js, k) for k in js.__dataclass_fields__
                                        if k != "key"})
    conv = quad_state_from_numpy(fields, "cpu")
    own, _, _ = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    for name in ("ctrl_step", "env_seed", "episode_idx", "current_gate", "task_completed"):
        assert torch.equal(getattr(conv, name), getattr(own, name)), name
    assert torch.equal(conv.dist_offsets["dynamics"], own.dist_offsets["dynamics"])
    assert conv.gates_eff.shape == own.gates_eff.shape
    torch.testing.assert_close(conv.x, own.x, rtol=1e-6, atol=2e-7)
    a = torch.full((B, 4), float(tenv.u_goal[0]))
    s1, _, r1, d1, _ = tenv.step(conv, a)
    s2, _, r2, d2, _ = tenv.step(own, a)
    torch.testing.assert_close(s1.x, s2.x, rtol=2e-4, atol=2e-5)
    assert torch.equal(d1, d2)


@pytest.mark.parametrize("kw", [
    dict(quad_type=2, physics="pyb_drag"), dict(physics="pyb_gnd"),
    dict(adversary_disturbance="dynamics"),
    dict(disturbances={"dynamics": ({"disturbance_func": "periodic", "scale": 0.1},)}),
    dict(disturbances={"dynamics": ({"disturbance_func": "brownian", "std": 0.1},)}),
    dict(disturbances={"dynamics": ({"disturbance_func": "white_noise", "std": 0.1},)}),
    dict(constraints=({"constraint_form": "linear_constraint",
                       "constrained_variable": "input", "A": [[1, 1, 1, 1]], "b": [1.0]},)),
])
def test_unported_configs_raise(kw):
    """The configs the port refused until it ported their modules (two aero
    modes, the adversary channel, the periodic, brownian and white-noise
    dynamics disturbances, a linear input constraint) now build in both
    packages and step from the same state under the same action (and the
    same adversary force): the states at the suite's tolerances (rtol 2e-4
    / atol 2e-5), done flags exact, constraint values at the tolerances.
    The periodic phase and the white noise are the packages' own draws
    (held in distribution in tests/test_torch_env_surface.py): there the
    states agree to within 5 noise-driven velocity changes (5 x 0.1 N /
    the lightest mass x the control step, on either package's side)."""
    jenv, tenv = _envs(**kw)
    js, _, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(1), B))
    fields = jax.tree.map(np.asarray, {k: getattr(js, k) for k in js.__dataclass_fields__
                                        if k != "key"})
    ts = quad_state_from_numpy(fields, "cpu")
    rng = np.random.default_rng(2)
    nu = tenv.spaces.action_dim
    a = (float(jenv.u_goal[0]) * (1.0 + 0.1 * rng.uniform(-1, 1, (B, nu)))).astype(np.float32)
    if kw.get("adversary_disturbance"):
        adv = rng.uniform(-1.5, 1.5, (B, 3)).astype(np.float32)
        js = jax.vmap(jenv.extras["set_adversary_control"])(js, jnp.asarray(adv))
        ts = tenv.extras["set_adversary_control"](ts, torch.from_numpy(adv))
        np.testing.assert_allclose(ts.adv_force.numpy(), np.asarray(js.adv_force), rtol=1e-6)
    js1, _, jr, jd, ji = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(a))
    ts1, _, tr, td, ti = tenv.step(ts, torch.from_numpy(a))
    noise = (kw.get("disturbances") or {}).get("dynamics", ({},))[0].get("disturbance_func")
    if noise in ("periodic", "white_noise"):
        dv = 5 * 0.1 / 0.022 / CFG4["ctrl_freq"]
        assert np.abs(ts1.x.numpy() - np.asarray(js1.x)).max() < 2 * dv
        assert np.abs(ts1.x.numpy() - np.asarray(js1.x))[:, [1, 3, 5]].max() > 1e-5
        assert torch.isfinite(ts1.x).all()
        return
    np.testing.assert_allclose(ts1.x.numpy(), np.asarray(js1.x), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(ti["constraint_values"].numpy(),
                               np.asarray(ji["constraint_values"]), rtol=2e-4, atol=2e-5)
    assert not ts1.adv_force.any() and not np.asarray(js1.adv_force).any()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA"):
        tq.make_quadrotor(tq.QuadrotorConfig(**CFG4))


def test_gate_geometry_matches_jax():
    rng = np.random.default_rng(3)
    pos = rng.uniform([-1, -1, 0], [1, 1, 1.5], (64, 3)).astype(np.float32)
    gxy = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    gyaw = rng.uniform(-1, 1, 3).astype(np.float32)
    gh = np.array([1.0, 0.525, 1.0], np.float32)
    oxy = rng.uniform(-1, 1, (2, 2)).astype(np.float32)
    T = torch.from_numpy
    for tf, jf, args in [
        (tg.gate_pass_hit, jg.gate_pass_hit, (gxy, gyaw, gh)),
        (tg.gate_collision, jg.gate_collision, (gxy, gyaw, gh)),
        (tg.gate_in_range, jg.gate_in_range, (gxy, gh)),
        (tg.gate_frame_margin, jg.gate_frame_margin, (gxy, gyaw, gh)),
        (tg.obstacle_collision, jg.obstacle_collision, (oxy,)),
        (tg.obstacle_margin, jg.obstacle_margin, (oxy,)),
    ]:
        want = np.asarray(jax.vmap(lambda p: jf(p, *map(jnp.asarray, args)))(pos))
        got = tf(T(pos), *map(T, args)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=tf.__name__)
    np.testing.assert_array_equal(tg.ground_collision(T(pos)).numpy(),
                                  np.asarray(jax.vmap(jg.ground_collision)(pos)))
