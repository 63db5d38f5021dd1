"""BASELINE config 5, the competition maze, in the port against the JAX
package on the CPU: the general engine's reset draws and competition step,
the plain K2 maze step (against the port's general engine and against the
JAX package's ``step_env_core``), the in-kernel pose redraws, the maze
envelope of ``fast_env.supports``, the uniform disturbance and K2's step
noise in distribution, and the Philox call site of the dynamics channel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.baseline import LEVEL2_GATES, LEVEL2_OBSTACLES, cfg5
from safe_control_gym_torch.envs import gates as tg
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.envs.disturbances import build_disturbances
from safe_control_gym_torch.ops import ctr_prng, philox
from safe_control_gym_torch.parallel import fast_env as tf
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils.convert import quad_state_from_numpy
from safe_control_gym_tpu.envs import disturbances as jd
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import ctr_prng as jcp
from safe_control_gym_tpu.parallel import fast_env as jf
from safe_control_gym_tpu.parallel.vector import make_vec_env as jax_vec_env

B = 1024
# tests/test_fast_maze.py's config: the level-2 maze with spawns scattered
# over the arena, 4 s episodes, collision and completion done; no step
# noise (it agrees with the JAX package's in distribution only).
MAZE = dict(
    episode_len_sec=4, randomized_inertial_prop=False,
    init_state_randomization_info={
        "init_x": {"distrib": "uniform", "low": -2.0, "high": 2.0},
        "init_y": {"distrib": "uniform", "low": -2.5, "high": 2.0},
        "init_z": {"distrib": "uniform", "low": 0.1, "high": 1.4}},
    done_on_completion=True, disturbances=None)
NOISE = cfg5().disturbances
_FIELDS = ("gates_eff", "obstacles_eff", "x", "mass", "j_diag")
_EXACT_ROWS = [16, 17, 21, 26]  # step, offset, done count, episode index


def _config5(**kw):
    """BASELINE config 5's fields (the port's dtype field aside), updated."""
    return {**{k: v for k, v in cfg5().__dict__.items() if k != "dtype"}, **kw}


def _cfg(**kw):
    return _config5(**{**MAZE, **kw})


def _envs(**kw):
    cfg = _cfg(**kw)
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg, use_pallas=False)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


def _fields(js):
    return jax.tree.map(np.asarray, {k: getattr(js, k) for k in js.__dataclass_fields__
                                     if k != "key"})


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def maze():
    """Both packages' config-5 envs (no step noise), a JAX batch of B
    scattered spawns at step 40 (past the settling window, clear of the
    time limit), with envs 0-63 placed at their current gate's aperture
    centre and envs 64-95 at the goal past the last gate, one step from
    completion; and the same batch in the port."""
    jenv, tenv = _envs()
    st, _, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(3), B))
    x = np.array(st.x)
    ge = np.asarray(st.gates_eff)
    x[:64] = 0.0
    x[:64, 0], x[:64, 2], x[:64, 4] = ge[:64, 0, 0], ge[:64, 0, 1], ge[:64, 0, 3]
    x[64:96] = 0.0
    x[64:96, [0, 2, 4]] = np.asarray(jenv.x_goal, np.float32)[[0, 2, 4]]
    cur = np.zeros(B, np.int32)
    cur[64:96] = len(LEVEL2_GATES)
    at_goal = np.zeros(B, np.int32)
    at_goal[64:96] = 2 * 30
    st = st.replace(x=jnp.asarray(x), ctrl_step=jnp.full((B,), 40, jnp.int32),
                    pyb_step=jnp.full((B,), 80, jnp.int32), current_gate=jnp.asarray(cur),
                    steps_at_goal=jnp.asarray(at_goal))
    return jenv, tenv, st, quad_state_from_numpy(_fields(st), "cpu")


def _actions(hover, kind):
    if kind == "hover":
        return np.full((B, 4), hover, np.float32)
    rng = np.random.default_rng(7)
    return (hover * (1.0 + 0.2 * rng.uniform(-1, 1, (B, 4)))).astype(np.float32)


def _near_margin(tstate, x, tenv, tol=1e-5):
    """Envs whose post-step position lies within ``tol`` of a boundary of
    the maze's geometry: a gate frame or leg (gates.gate_frame_margin), an
    obstacle (obstacle_margin), the ground, a gate's ray fan or the goal
    sphere."""
    pos = x[:, [0, 2, 4]]
    ge, oe = tstate.gates_eff, tstate.obstacles_eff
    m = [tg.gate_frame_margin(pos, ge[..., :2], ge[..., 2], ge[..., 3]).abs().min(-1).values,
         tg.obstacle_margin(pos, oe).abs().min(-1).values,
         (pos[:, 2] - tg.GROUND_COLLISION_Z).abs()]
    offsets = torch.arange(-3, 4, dtype=pos.dtype) * tg.RAY_SPACING
    d = torch.stack([torch.cos(ge[..., 2]), torch.sin(ge[..., 2])], -1)
    seg = ge[..., None, :2] + offsets[:, None] * d[..., None, :]
    dz = torch.clamp(pos[:, None, None, 2], (ge[..., 3] - tg.RAY_HALF_LENGTH)[..., None],
                     (ge[..., 3] + tg.RAY_HALF_LENGTH)[..., None]) - pos[:, None, None, 2]
    dist = torch.sqrt(((pos[:, None, None, :2] - seg) ** 2).sum(-1) + dz * dz)
    m.append((dist - tg.DRONE_RADIUS).abs().flatten(1).min(-1).values)
    goal = torch.as_tensor(np.asarray(tenv.x_goal, np.float32)[[0, 2, 4]])
    m.append((torch.linalg.norm(pos - goal, dim=-1) - 0.15).abs())
    return torch.stack(m, -1).min(-1).values < tol


@pytest.mark.parametrize("episode", [0, 1])
@pytest.mark.parametrize("randomized", [True, False])
def test_reset_draws_bit_exact(randomized, episode):
    """gates_eff, obstacles_eff, x, mass and j_diag of the port's reset and
    reset_episode against the JAX package's (op by op, as the port
    computes them), bit for bit."""
    jenv, tenv = _envs(randomized_gates_and_obstacles=randomized, randomized_inertial_prop=True)
    js, _, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(1), 256))
    ts, _, _ = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    if episode:
        js = jax.vmap(lambda s: jenv.extras["reset_episode"](s, jax.random.key(0))[0])(js)
        ts = tenv.extras["reset_episode"](ts)[0]
    for name in _FIELDS:
        np.testing.assert_array_equal(_bits(getattr(ts, name)), _bits(getattr(js, name)),
                                      err_msg=name)
    nominal = np.asarray(LEVEL2_GATES, np.float32)[:, [0, 1, 5]]
    moved = not np.array_equal(np.asarray(js.gates_eff)[:, :, :3],
                               np.broadcast_to(nominal, (256, 4, 3)))
    assert moved == randomized


@pytest.mark.parametrize("kind", ["hover", "random"])
def test_general_step_matches_jax(maze, kind):
    """One general-engine step from the same B scattered states: done,
    collision, current gate, at-goal and completion exact, reward atol
    1e-4, states rtol 2e-4 / atol 2e-5, every competition info key present
    and equal; envs within 1e-5 of a margin are left out (under 1%)."""
    jenv, tenv, js, ts = maze
    a = _actions(float(jenv.u_goal[0]), kind)
    js1, _, jrew, jdone, jinfo = jax.jit(jax_vec_env(jenv, B).step_no_reset)(js, jnp.asarray(a))
    ts1, _, trew, tdone, tinfo = tenv.step(ts, torch.tensor(a))
    x_j = torch.tensor(np.asarray(js1.x))
    torch.testing.assert_close(ts1.x, x_j, rtol=2e-4, atol=2e-5)
    skip = _near_margin(ts, x_j, tenv)
    assert int(skip.sum()) < 0.01 * B
    keep = ~skip.numpy()
    np.testing.assert_array_equal(tdone.numpy()[keep], np.asarray(jdone)[keep])
    np.testing.assert_allclose(trew.numpy()[keep], np.asarray(jrew)[keep], atol=1e-4)
    for name in ("current_gate", "stepped_through_gate", "currently_collided", "at_goal_pos",
                 "steps_at_goal", "task_completed"):
        np.testing.assert_array_equal(getattr(ts1, name).numpy()[keep],
                                      np.asarray(getattr(js1, name))[keep], err_msg=name)
    assert set(jinfo) <= set(tinfo)
    for k, v in jinfo.items():
        v, w = np.asarray(v), tinfo[k].numpy()
        if v.dtype.kind == "f":
            np.testing.assert_allclose(w[keep], v[keep], rtol=2e-4, atol=2e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(w[keep], v[keep], err_msg=k)
    # The placed envs exercise the gate progress and the completion.
    assert bool(ts1.stepped_through_gate[:64].all()) and bool(ts1.task_completed[64:96].all())
    assert 0.005 < float(tdone.double().mean()) < 0.9


@pytest.mark.parametrize("kind", ["hover", "random"])
def test_plain_k2_step_matches_general_engine(maze, kind):
    """One plain K2 step from the packed states against the port's general
    engine (tests/test_fast_maze.py:74-110): done exact, reward atol 1e-4,
    the states of the envs that are not done rtol 2e-4 / atol 2e-5, the
    maze counters of those envs exact."""
    _, tenv, _, ts = maze
    fr = tf.FastQuadRollout(tenv, B, steps_per_call=1, device="cpu")
    a = _actions(float(tenv.u_goal[0]), kind)
    rows = fr.run(fr.pack(ts), a, seed=1)
    ts1, _, rew, done, _ = tenv.step(ts, torch.tensor(a))
    assert torch.equal(rows[21] > 0.5, done)
    torch.testing.assert_close(rows[18] + rows[22], rew, rtol=0, atol=1e-4)
    live = ~done
    torch.testing.assert_close(rows[:12, live].T, ts1.x[live], rtol=2e-4, atol=2e-5)
    mz = tf._NROWS + 4 * 4 + 2 * 4
    assert torch.equal(rows[mz, live], ts1.current_gate[live].float())
    assert torch.equal(rows[mz + 1, live], ts1.steps_at_goal[live].float())
    assert 0.005 < float(done.double().mean()) < 0.9


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("kind", ["hover", "random"])
def test_plain_k2_step_matches_jax_step_env_core(maze, kind, noise):
    """The plain K2 step against the JAX package's step_env_core (K2's
    plain reference) on the JAX package's own engine params, from the same
    packed rows, with zero step-noise draws on both sides: the step, offset,
    done, episode and maze rows and the seed bits exact, the states and
    statistics at the JAX suite's tolerances."""
    jenv, tenv, js, ts = maze
    if noise:
        jenv, tenv = _envs(disturbances=NOISE)
    jp = jf.build_engine_params(jenv, 1, interpret=True, allow_maze=True)
    tp = tf.build_engine_params(tenv, 1, allow_maze=True)
    rows = tf.FastQuadRollout(tenv, B, steps_per_call=1, device="cpu").pack(ts)
    a = _actions(float(jenv.u_goal[0]), kind)
    thr = np.clip(a, jp["a_low"], jp["a_high"]).T
    zero = lambda n, salt: jnp.zeros((n, B), jnp.float32)  # noqa: E731
    jout = jf.step_env_core(jp, tuple(jnp.asarray(r) for r in rows.numpy()),
                            [jnp.asarray(t) for t in thr], 0, zero, act_rows=list(jnp.asarray(a.T)))
    tout = tf.step_rows(tp, list(rows.unbind(0)), list(torch.tensor(thr)), list(torch.tensor(a.T)),
                        (torch.zeros(8, B), torch.zeros(3, B)))
    jr = np.stack([np.asarray(r) for r in jout[0]])
    tr = torch.stack(tout[0]).numpy()
    exact = _EXACT_ROWS + list(range(tf._NROWS, tf.total_rows(tp)))
    np.testing.assert_array_equal(tr[exact], jr[exact])
    np.testing.assert_array_equal(tr.view(np.int32)[25], jr.view(np.int32)[25])
    np.testing.assert_allclose(tr[:16], jr[:16], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tr[18:25], jr[18:25], rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-4)


def test_pose_redraws_within_one_ulp_of_general_reset(maze):
    """Every env at its last step: one plain K2 step resets all in-kernel,
    and the redrawn poses, states and inertia are within one float32 ulp of
    the general engine's reset_episode: the kernel rounds nominal + low once
    from float64, the general engine adds the two in float32, so the sums
    differ by up to an ulp of nominal + low, and the draws by that and the
    final rounding.  The gate heights are exact."""
    _, tenv, _, ts = maze
    ts = ts.replace(ctrl_step=torch.full((B,), 4 * 30 - 1, dtype=torch.int32))
    fr = tf.FastQuadRollout(tenv, B, steps_per_call=1, device="cpu")
    rows = fr.run(fr.pack(ts), np.full(4, float(tenv.u_goal[0])), seed=1)
    assert float(rows[21].sum()) == B
    nxt = tenv.extras["reset_episode"](ts)[0]
    NG, NO = 4, 4
    a_pose, _ = tf.pose_affine(fr.params)
    p = fr.params
    a_rand = np.asarray(p["rand_nominal"]) + np.asarray(p["rand_lo"])
    a = {"gates_eff": np.concatenate([np.reshape(a_pose[:12], (NG, 3)),
                                      np.asarray(p["gates_nom"])[:, 3:]], -1),
         "obstacles_eff": np.reshape(a_pose[12:], (NO, 2)), "x": a_rand[4:], "mass": a_rand[0],
         "j_diag": a_rand[1:4]}
    o0 = tf._NROWS + 4 * NG
    got = {"gates_eff": rows[tf._NROWS:o0].T.reshape(B, NG, 4),
           "obstacles_eff": rows[o0:o0 + 2 * NO].T.reshape(B, NO, 2),
           "x": rows[:12].T, "mass": rows[12], "j_diag": rows[13:16].T}
    for name, v in got.items():
        want = getattr(nxt, name).numpy()
        ulp = np.spacing(np.abs(np.float32(a[name]))) + np.spacing(np.abs(want))
        assert (np.abs(v.numpy() - want) <= ulp).all(), name
    np.testing.assert_array_equal(got["gates_eff"][..., 3].numpy(), nxt.gates_eff[..., 3].numpy())
    assert not torch.equal(got["gates_eff"], ts.gates_eff)
    mz = tf._NROWS + 4 * NG + 2 * NO
    assert not rows[mz:mz + 3].any()  # counters reset


_GATE = [[0.5, -1.0, 0, 0, 0, 0, 0]]
_SUPPORT_TABLE = {
    "config5": {},
    "config5_no_noise": dict(disturbances=None),
    "competition_without_gates": dict(gates=None, obstacles=None),
    "gates_without_competition": dict(cost="rl_reward"),
    "per_axis_uniform": dict(disturbances={"dynamics": (
        {"disturbance_func": "uniform", "low": [-0.1, -0.2, 0.0], "high": [0.1, 0.2, 0.3]},)}),
    "masked_uniform": dict(disturbances={"dynamics": (
        {"disturbance_func": "uniform", "mask": [1, 0, 1]},)}),
    "two_action_noise_entries": dict(disturbances={"action": (
        {"disturbance_func": "white_noise", "std": 0.001},
        {"disturbance_func": "white_noise", "std": 0.002})}),
    "per_motor_action_noise": dict(disturbances={"action": (
        {"disturbance_func": "white_noise", "std": [0.001, 0.002, 0.001, 0.002]},)}),
    "done_on_completion": dict(done_on_completion=True),
    "done_on_violation": dict(done_on_violation=True),
    "impulse_in_the_maze": dict(disturbances={"dynamics": (
        {"disturbance_func": "impulse", "magnitude": 0.01},)}),
    "obs_noise": dict(disturbances={"observation": (
        {"disturbance_func": "white_noise", "std": 0.01},)}),
    "quad_2d": dict(quad_type=2, gates=None, obstacles=None),
    "eight_gates": dict(gates=LEVEL2_GATES * 2, obstacles=LEVEL2_OBSTACLES * 2),
    "nine_gates_above_the_cap": dict(gates=LEVEL2_GATES * 2 + (_GATE[0],)),
    "nine_obstacles_above_the_cap": dict(obstacles=LEVEL2_OBSTACLES * 2 + ([0, 0, 0, 0, 0, 0],)),
}


@pytest.mark.parametrize("case", sorted(_SUPPORT_TABLE))
def test_supports_maze_envelope_matches_jax(case):
    """fast_env.supports(allow_maze=True) against the JAX package's: equal on
    every config but those above the port's cap of 8 gates and 8
    obstacles, which the JAX kernel takes and the port refuses."""
    cfg = _config5(**_SUPPORT_TABLE[case])
    got = tf.supports(tq.QuadrotorConfig(**cfg), allow_maze=True)
    want = jf.supports(jq.QuadrotorConfig(**cfg), allow_maze=True)
    if "above_the_cap" in case:
        assert want and not got
    else:
        assert got == want
    assert not tf.supports(tq.QuadrotorConfig(**cfg), allow_maze=False) or not (
        cfg["gates"] or cfg["cost"] == "competition")


def test_config5_builds_on_both_engines():
    """make_quadrotor builds BASELINE config 5 as bench.py has it, and
    FastQuadRollout takes it with its default allow_maze=True; the engine
    params and the reset rows are the JAX package's."""
    cfg = _config5()
    jenv = jq.make_quadrotor(jq.QuadrotorConfig(**cfg))
    tenv = tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu")
    fr = tf.FastQuadRollout(tenv, 64, steps_per_call=8192, device="cpu")
    jp = jf.build_engine_params(jenv, 8192, interpret=True, allow_maze=True)
    assert fr.n_rows == jf.total_rows(jp) == 27 + 4 * 4 + 2 * 4 + 4
    for k, v in fr.params.items():
        assert str(v) == str(jp[k]), k
    seeds = np.asarray(jax.vmap(jcp.env_seed_from_key)(jax.random.split(jax.random.key(0), 64)))
    jrows = np.asarray(jf.reset_rows(jp, 64, 1, 64, seed=0)).reshape(-1, 64)
    trows = fr.reset(env_seeds=torch.tensor(seeds)).numpy()
    np.testing.assert_array_equal(trows.view(np.int32), jrows.view(np.int32))
    # The general engine's state packs to the same rows, but for the
    # impulse-offset row, which it holds only for an impulse (as the JAX
    # package's pack does).
    state, _, _ = make_vec_env(tenv, 64).reset(env_seeds=torch.tensor(seeds))
    rows = [r for r in range(fr.n_rows) if r != 17]
    assert torch.equal(fr.pack(state).view(torch.int32)[rows],
                       torch.tensor(trows).view(torch.int32)[rows])


def test_plain_k2_maze_rollout_counts_episodes():
    """60 hover steps of the plain K2 on config 5 with its step noise: finite
    statistics, collision and time-limit resets turn episodes over, and the
    sparse reward is collision-dominated (tests/test_fast_maze.py:113-125)."""
    _, tenv = _envs(disturbances=NOISE)
    fr = tf.FastQuadRollout(tenv, 256, steps_per_call=60, device="cpu")
    rows = fr.run(fr.reset(seed=0), np.full(4, float(tenv.u_goal[0])), seed=2)
    stats = fr.stats(rows)
    assert np.isfinite(list(stats.values())).all() and torch.isfinite(rows[:25]).all()
    assert stats["episodes"] > 0
    assert stats["mean_return"] < 0
    again = fr.run(fr.reset(seed=0), np.full(4, float(tenv.u_goal[0])), seed=3)
    assert not torch.equal(again[:12], rows[:12])  # the call seed keys the noise


def test_uniform_disturbance_matches_jax_in_distribution():
    """The general engine's uniform dynamics disturbance (``u * (high -
    low) + low`` times the mask) over 2^17 draws against the JAX package's:
    inside [low, high), mean and std of each axis within 4 sigma of the
    JAX sample's and of the uniform law's; the masked axis stays zero."""
    spec = ({"disturbance_func": "uniform", "low": [-0.1, -0.2, 0.0], "high": [0.1, 0.2, 0.3],
             "mask": [1, 1, 0]},)
    n = 1 << 17
    prog = build_disturbances(spec, 3, 15, 30, channel="dynamics")
    es = ctr_prng.env_seeds_from_seed(0, n)
    t = prog.apply(torch.zeros((n, 0), dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
                   torch.zeros((n, 3)), (es, torch.zeros_like(es))).double().numpy()
    jprog = jd.build_disturbances(spec, 3, 15, 30, 60)
    keys = jax.random.split(jax.random.key(0), n)
    j = np.asarray(jax.vmap(lambda k: jprog.apply(jprog.init(k), k, jnp.int32(0), jnp.int32(0),
                                                  jnp.zeros(3, jnp.float32)))(keys), float)
    lo, hi = np.array([-0.1, -0.2, 0.0]), np.array([0.1, 0.2, 0.3])
    for k in range(2):
        assert (t[:, k] >= lo[k]).all() and (t[:, k] < hi[k]).all()
        sd = (hi[k] - lo[k]) / np.sqrt(12)
        for m in (t[:, k].mean(), j[:, k].mean()):
            assert abs(m - (lo[k] + hi[k]) / 2) < 4 * sd / np.sqrt(n)
        assert abs(t[:, k].std() / j[:, k].std() - 1) < 0.01
        assert abs(t[:, k].std() / sd - 1) < 0.01
    assert not t[:, 2].any() and not j[:, 2].any()


def test_k2_step_noise_matches_jax_forms_in_distribution():
    """K2's step noise from its Philox draws (fast_env.step_noise) in the
    JAX kernel's forms over 2^17 envs: the action white noise std *
    sqrt(-2 log(1 - u_i)) cos(2 pi u_{4+i}) has mean 0 and std 0.001 on
    each motor, the uniform force lo + u (hi - lo) lies in [-0.1, 0.1)
    with the uniform law's mean and std, and the two call sites draw
    different words."""
    n = 1 << 17
    env = torch.arange(n)
    p = tf.build_engine_params(_envs(disturbances=NOISE)[1], 1, allow_maze=True)
    u_act, u_dyn = tf.step_noise(p, 11, 5, env)
    std = p["act_noise_std"]
    for i in range(4):
        eps = (std * torch.sqrt(-2.0 * torch.log(1.0 - u_act[i]))
               * torch.cos(philox.TWO_PI * u_act[4 + i])).double()
        assert abs(float(eps.mean())) < 4 * std / np.sqrt(n)
        assert abs(float(eps.std()) / std - 1) < 0.01
    lo3, hi3 = p["dyn_uniform"]
    for k in range(3):
        f = (lo3[k] + u_dyn[k] * (hi3[k] - lo3[k])).double()
        assert float(f.min()) >= -0.1 and float(f.max()) < 0.1
        assert abs(float(f.mean())) < 4 * 0.2 / np.sqrt(12 * n)
        assert abs(float(f.std()) / (0.2 / np.sqrt(12)) - 1) < 0.01
    assert float((u_act[:3] == u_dyn).double().mean()) < 1e-3


def _philox_reference(ctr, key):
    """Philox-4x32-10 in Python integers (Salmon et al.), independent of
    ops/philox.py's 16-bit split."""
    c, (k0, k1) = list(ctr), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & 0xFFFFFFFF, p1 & 0xFFFFFFFF,
             ((p0 >> 32) ^ c[3] ^ k1) & 0xFFFFFFFF, p0 & 0xFFFFFFFF]
    return c


def test_philox_dynamics_site_known_answer():
    """Call site 3 (SITE_DYNAMICS, the CUDA kernels' too): the words of
    ``ctr = (env, step, block, 3)``, ``key = (seed, 0)`` against known
    answers and the reference above, and the uniforms they make."""
    from pathlib import Path

    src = (Path(tf.__file__).parents[1] / "csrc" / "philox.cuh").read_text()
    assert philox.SITE_DYNAMICS == 3 and "SITE_DYNAMICS = 3;" in src
    assert _philox_reference((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                                        0x9B00DBD8]
    want = {(7, 5, 0, 3, 11): [0x591C9A37, 0x45A223FA, 0x64603656, 0x59F8BACB]}
    for (e, t, blk, site, seed), words in want.items():
        ref = _philox_reference((e, t, blk, site), (seed, 0))
        got = philox.philox4x32(*(torch.tensor([v]) for v in (e, t, blk, site, seed, 0)))
        assert [int(w) for w in got] == ref == words
        u = philox.uniforms(seed, t, torch.tensor([e]), 3, philox.SITE_DYNAMICS)[:, 0]
        assert u.tolist() == [(w >> 8) * 2.0**-24 for w in words[:3]]
