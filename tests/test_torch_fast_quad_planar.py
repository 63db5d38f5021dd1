"""K7 and K8, the planar-quadrotor whole-rollout engines
(``parallel/fast_quad_planar.py``), on the 1D and 2D quads: the plain
versions against the JAX package's K7 (Pallas interpret mode), the JAX
package's policy and general engine, and the port's own general engine
through auto-resets; the CUDA kernels against the plain versions on a card.
Noise-free configs for the step-exact comparisons; the JAX side of the K8
checks is handed the port's recorded observations and actions."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.ppo import ActorCritic
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.ops import philox
from safe_control_gym_torch.parallel import fast_quad_planar as tf
from safe_control_gym_torch.parallel import rollout as tro
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers.ppo import PPO as JPPO
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import ctr_prng as jp
from safe_control_gym_tpu.parallel import fast_quad_planar as jf
from safe_control_gym_tpu.parallel.vector import make_vec_env as j_make_vec_env
from test_torch_fast_env import lane_groups  # csrc/lane_group_planar.cuh maps threads alike

B, T, SEED = 128, 8, 3
BOX = ({"constraint_form": "default_constraint", "constrained_variable": "state"},)
CFG3 = dict(quad_type=2, ctrl_freq=50, pyb_freq=200, episode_len_sec=10, task="stabilization",
            task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.05},
            randomized_init=True, randomized_inertial_prop=True, constraints=BOX,
            done_on_out_of_bound=True)
IMPULSE = {"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.02, "duration": 4,
                         "decay_rate": 0.8},)}
OBS_NOISE = {"observation": ({"disturbance_func": "white_noise", "std": 0.1},)}
_K7_VARIANTS = {
    "config3_short_episodes": (dict(CFG3, episode_len_sec=0.3), 1.1),
    "2d_euler_impulse_input_box": (dict(CFG3, physics="dyn", disturbances=IMPULSE, constraints=BOX + (
        {"constraint_form": "bounded_constraint", "constrained_variable": "input",
         "lower_bounds": [0.0, 0.0], "upper_bounds": [0.1, 0.1]},)), 1.6),
    "2d_quadratic_figure8": (dict(CFG3, cost="quadratic", task="traj_tracking", episode_len_sec=0.3,
                                  task_info={"trajectory_type": "figure8",
                                             "trajectory_plane": "xz"}), 0.9),
    "1d_stabilization": (dict(CFG3, quad_type=1), 1.4),
    "1d_euler_circle_impulse": (dict(CFG3, quad_type=1, physics="dyn", task="traj_tracking",
                                     episode_len_sec=0.3, disturbances=IMPULSE), 1.0),
}


def _jax_seeds(seed=0, n=B):
    return np.asarray(jax.vmap(jp.env_seed_from_key)(jax.random.split(jax.random.key(seed), n)))


def _envs(cfg):
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg, use_pallas=False)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


def test_supports_envelope():
    assert tf.supports(tq.QuadrotorConfig(**CFG3))
    assert tf.supports(tq.QuadrotorConfig(**{**CFG3, "quad_type": 1, "disturbances": {
        "action": ({"disturbance_func": "white_noise", "std": 0.001},)}}))
    bad = [dict(quad_type=3), dict(obs_goal_horizon=2), dict(physics="pyb_gnd"),
           dict(normalized_rl_action_space=True), dict(done_on_collision=True),
           dict(rew_act_weight=[1e-4, 2e-4]),
           dict(disturbances={"observation": ({"disturbance_func": "white_noise", "std": 0.1,
                                                "mask": [1, 0, 1, 0, 1, 0]},)})]
    for kw in bad:
        assert not tf.supports(tq.QuadrotorConfig(**{**CFG3, **kw})), kw
    assert tf.supports(tq.QuadrotorConfig(**CFG3, normalized_rl_action_space=True),
                       allow_normalized=True)
    # Scalar observation white noise: K7 admits it, and so does K8
    # (allow_normalized=True), which draws it.
    noisy = tq.QuadrotorConfig(**CFG3, disturbances=OBS_NOISE)
    assert tf.supports(noisy)
    assert tf.supports(noisy, allow_normalized=True)
    # Goal-horizon rows: K8's (allow_goal_horizon), rl_reward only, as the
    # JAX package's, up to an observation of 128 rows (2D tracking h = 20:
    # 126); the JAX kernel has no cap (h = 21: 132).
    for qt, h, task, want in ((2, 2, "stabilization", True), (2, 20, "traj_tracking", True),
                              (2, 21, "traj_tracking", False), (1, 63, "traj_tracking", True),
                              (1, 64, "traj_tracking", False)):
        cfg = {**CFG3, "quad_type": qt, "obs_goal_horizon": h, "task": task,
               "normalized_rl_action_space": True}
        got = tf.supports(tq.QuadrotorConfig(**cfg), allow_normalized=True,
                          allow_goal_horizon=True)
        assert got == want and jf.supports(jq.QuadrotorConfig(**cfg), allow_normalized=True,
                                           allow_goal_horizon=True), (qt, h, task)
        assert not tf.supports(tq.QuadrotorConfig(**cfg), allow_normalized=True)


@pytest.mark.parametrize("quad_type", [1, 2])
def test_obs_noise_leaves_k7_rows_unchanged(quad_type):
    """Config 3 (and the 1D quad) with action noise, with and without
    scalar observation white noise: K7 never reads the observation, so the
    plain rows are bit-equal after 25 steps through resets."""
    act_noise = {"action": ({"disturbance_func": "white_noise", "std": 0.001},)}
    rows = []
    for dist in (act_noise, {**act_noise, **OBS_NOISE}):
        env = tq.make_quadrotor(tq.QuadrotorConfig(**dict(
            CFG3, quad_type=quad_type, episode_len_sec=0.2, disturbances=dist)), device="cpu")
        fr = tf.FastPlanarQuadRollout(env, B, steps_per_call=25, device="cpu")
        act = fr.prepare_action(np.full(fr.params["nu"], float(env.u_goal[0]), np.float32))
        rows.append(fr.run(fr.reset(seed=0), act, seed=7))
    assert float(rows[0][tf.exact_rows(fr.params["nx"])].sum()) > 0
    assert torch.equal(rows[0].view(torch.int32), rows[1].view(torch.int32))


@pytest.mark.parametrize("quad_type", [1, 2])
def test_k8_refuses_obs_noise(quad_type):
    """K8 feeds the observation to the policy and draws a scalar
    observation white noise in-kernel; it refuses a masked or vector-std
    one, as the JAX package's does."""
    env = tq.make_quadrotor(tq.QuadrotorConfig(**dict(
        CFG3, quad_type=quad_type, normalized_rl_action_space=True, disturbances=OBS_NOISE)),
        device="cpu")
    fp = tf.FastPlanarQuadPolicyRollout(env, 8, 2, device="cpu")
    assert fp.params["obs_noise_std"] == OBS_NOISE["observation"][0]["std"] and fp.obs_dim == fp.nx
    nx = fp.nx
    for spec in ({"mask": [1] + [0] * (nx - 1)}, {"std": [0.01] * nx}):
        dist = {"observation": ({**OBS_NOISE["observation"][0], **spec},)}
        cfg = dict(CFG3, quad_type=quad_type, normalized_rl_action_space=True, disturbances=dist)
        assert not jf.supports(jq.QuadrotorConfig(**cfg), allow_normalized=True)
        with pytest.raises(ValueError, match="envelope"):
            tf.FastPlanarQuadPolicyRollout(tq.make_quadrotor(tq.QuadrotorConfig(**cfg),
                                                             device="cpu"), 8, 2, device="cpu")


@pytest.mark.parametrize("quad_type", [1, 2])
def test_engine_params_and_reset_rows_match_jax(quad_type):
    cfg = dict(CFG3, quad_type=quad_type, disturbances=IMPULSE, task="traj_tracking")
    jenv, tenv = _envs(cfg)
    jpar = jf.build_engine_params(jenv, 25, interpret=True)
    tpar = tf.build_engine_params(tenv, 25)
    for k, v in tpar.items():
        assert np.array_equal(np.asarray(v, dtype=object), np.asarray(jpar[k], dtype=object)), k
    nx = tpar["nx"]
    jrows = np.asarray(jf.reset_rows(jpar, B, 1, B, seed=0)).reshape(nx + 13, B)
    trows = tf.reset_rows(tpar, torch.tensor(_jax_seeds(0))).numpy()
    np.testing.assert_array_equal(trows.view(np.int32), jrows.view(np.int32))


@pytest.mark.parametrize("variant", list(_K7_VARIANTS))
def test_plain_k7_matches_jax_kernel(variant):
    """25 steps from reset at B = 128 with a constant thrust of ``scale``
    times hover: the plain K7 against the JAX package's K7 (Pallas
    interpret mode), auto-resets inside the window."""
    cfg, scale = _K7_VARIANTS[variant]
    jenv, tenv = _envs(cfg)
    nx, nu = tf.nx_nu(cfg["quad_type"])
    act = np.full(nu, scale * float(jenv.u_goal[0]), np.float32)
    jfr = jf.FastPlanarQuadRollout(jenv, B, steps_per_call=25, sub=1, interpret=True)
    jrows = np.asarray(jfr.run(jfr.reset(seed=0), act, seed=0)).reshape(nx + 13, B)
    tfr = tf.FastPlanarQuadRollout(tenv, B, steps_per_call=25, device="cpu")
    before = tf.planar_rollout.launches
    trows = tfr.run(tfr.reset(env_seeds=torch.tensor(_jax_seeds(0))), act).numpy()
    assert tf.planar_rollout.launches == before  # CPU: the plain version
    L = tf.rows_layout(nx)
    assert jrows[L["STATS"] + 3].sum() > 0
    ex = tf.exact_rows(nx)
    np.testing.assert_array_equal(trows[ex], jrows[ex])
    np.testing.assert_array_equal(trows.view(np.int32)[L["SEED"]], jrows.view(np.int32)[L["SEED"]])
    np.testing.assert_allclose(trows[:nx], jrows[:nx], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(trows[nx:nx + 2], jrows[nx:nx + 2], rtol=1e-6)  # mass, iyy
    st = slice(L["STATS"], L["STATS"] + 7)
    np.testing.assert_allclose(trows[st], jrows[st], rtol=2e-4, atol=1e-5)
    assert tfr.stats(torch.from_numpy(trows))["episodes"] == jrows[L["STATS"] + 3].sum()


@pytest.mark.parametrize("quad_type", [1, 2])
def test_plain_k7_matches_general_engine_with_resets(quad_type):
    cfg = dict(CFG3, quad_type=quad_type, episode_len_sec=0.12, done_on_out_of_bound=False,
               disturbances=IMPULSE)
    env = tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu")
    nx, nu = tf.nx_nu(quad_type)
    L = tf.rows_layout(nx)
    seeds = torch.tensor(_jax_seeds(0))
    hover = float(env.u_goal[0])
    fr = tf.FastPlanarQuadRollout(env, B, steps_per_call=20, device="cpu")
    rows0 = fr.reset(env_seeds=seeds)
    vec = make_vec_env(env, B)
    state, obs, _ = vec.reset(env_seeds=seeds)
    assert torch.equal(fr.pack(state).view(torch.int32), rows0.view(torch.int32))
    rows = fr.run(rows0, np.full(nu, hover, np.float32))
    act = torch.full((B, nu), hover)
    carry, _ = tro.rollout(vec, lambda ps, o: (act, ps),
                           tro.RolloutCarry(state, obs, (), tro.EpisodeStats.create(B)), 20,
                           collect=False)
    es = carry.env_state
    torch.testing.assert_close(fr.states(rows), es.x, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(rows[L["MASS"]], es.mass, rtol=1e-6, atol=0)
    assert torch.equal(rows[L["OFFSET"]], es.dist_offsets["dynamics"][:, 0].float())
    assert torch.equal(rows[L["EP"]], es.episode_idx.float())
    assert torch.equal(rows[L["STATS"] + 3], carry.stats.done_count.float())
    assert torch.equal(rows[L["STEP"]], es.ctrl_step.float())
    torch.testing.assert_close(rows[L["STATS"] + 4], carry.stats.sum_return, rtol=2e-4, atol=1e-5)
    assert float(rows[L["STATS"] + 3].sum()) == 3 * B


@pytest.fixture(scope="module", params=[2, 1], ids=["2d", "1d"])
def policy_setup(request):
    cfg = dict(CFG3, quad_type=request.param, normalized_rl_action_space=True,
               disturbances=IMPULSE)
    jenv, tenv = _envs(cfg)
    nx, nu = tf.nx_nu(request.param)
    jppo = JPPO(jenv, seed=0, rollout_batch_size=B, rollout_steps=T)
    jac = jax.device_get(jppo.state.ac)
    rng = np.random.default_rng(1)
    jac = jac.replace(
        actor_params=jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                  jac.actor_params),
        logstd=np.asarray([-0.2, 0.1][:nu], np.float32))
    ac = ActorCritic(nx, nu, 64, "tanh")
    convert.load_actor_critic(ac, jac.actor_params, jac.critic_params, jac.logstd)
    fp = tf.FastPlanarQuadPolicyRollout(tenv, B, T, device="cpu")
    rows0 = fp.reset(env_seeds=torch.tensor(_jax_seeds(0)))
    weights = fp.pack_weights(ac.actor, ac.critic, ac.logstd)
    rows, traj = fp.run(rows0, weights, seed=SEED)
    return dict(jenv=jenv, tenv=tenv, jppo=jppo, jac=jac, ac=ac, fp=fp, rows0=rows0, nx=nx, nu=nu,
                weights=weights, rows=rows, traj=traj, d=fp.unpack_traj(traj))


def test_k8_record_shapes_and_finite(policy_setup):
    s = policy_setup
    nx, nu, d = s["nx"], s["nu"], s["d"]
    assert s["traj"].shape == (T, 2 * nx + nu + 5, B)
    assert d["obs"].shape == (T, B, nx) and d["act"].shape == (T, B, nu)
    for k, v in d.items():
        assert torch.isfinite(v).all(), k
    np.testing.assert_array_equal(d["obs"][0].numpy(), s["rows0"][:nx].T.numpy())


def test_plain_k8_matches_jax_policy(policy_setup):
    s = policy_setup
    jppo, jac, d, nu = s["jppo"], s["jac"], s["d"], s["nu"]
    obs, act = jnp.asarray(d["obs"].numpy()), jnp.asarray(d["act"].numpy())
    np.testing.assert_allclose(d["v"].numpy(), np.asarray(jppo._value(jac, obs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(d["logp"].numpy(), np.asarray(jppo._dist(jac, obs).log_prob(act)),
                               rtol=2e-3, atol=2e-3)
    mean = np.asarray(jppo._dist(jac, obs).loc, np.float64)
    eps = []
    for t in range(T):
        u = philox.uniforms(torch.tensor([SEED], dtype=torch.int32), t, torch.arange(B), 2 * nu)
        u = u.numpy().astype(np.float64)
        eps.append((np.sqrt(-2.0 * np.log(1.0 - u[:nu])) * np.cos(2.0 * np.pi * u[nu:])).T)
    want = mean + np.exp(np.asarray(jac.logstd, np.float64)) * np.stack(eps)
    np.testing.assert_allclose(d["act"].numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden", [32, 128])
def test_plain_k8_matches_jax_policy_at_width(policy_setup, hidden):
    """The plain K8 at hidden widths other than 64 (the kernel's
    run-time-width instance): recorded v and logp against the JAX package's
    critic and Gaussian actor of that width, weights carried by
    utils/convert.py (numpy-seeded noise on the actor)."""
    s = policy_setup
    nx, nu = s["nx"], s["nu"]
    jppo = JPPO(s["jenv"], seed=0, rollout_batch_size=16, rollout_steps=4, hidden_dim=hidden)
    jac = jax.device_get(jppo.state.ac)
    rng = np.random.default_rng(hidden)
    jac = jac.replace(
        actor_params=jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                  jac.actor_params),
        logstd=np.linspace(-0.4, 0.1, nu).astype(np.float32))
    ac = ActorCritic(nx, nu, hidden, "tanh")
    convert.load_actor_critic(ac, jac.actor_params, jac.critic_params, jac.logstd)
    fp = tf.FastPlanarQuadPolicyRollout(s["tenv"], 16, 4, mlp_hidden=hidden, device="cpu")
    _, traj = fp.run(fp.reset(seed=0), fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=SEED)
    d = fp.unpack_traj(traj)
    obs, act = jnp.asarray(d["obs"].numpy()), jnp.asarray(d["act"].numpy())
    np.testing.assert_allclose(d["v"].numpy(), np.asarray(jppo._value(jac, obs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(d["logp"].numpy(), np.asarray(jppo._dist(jac, obs).log_prob(act)),
                               rtol=2e-3, atol=2e-3)


def test_plain_k8_step_matches_jax_general_engine(policy_setup):
    """One K8 step from rows with spread control steps (some at the time
    limit) and some envs above the z bound, against the JAX package's
    vec.step_no_reset on the same states and the recorded actions."""
    s = policy_setup
    nx = s["nx"]
    L = tf.rows_layout(nx)
    fp1 = tf.FastPlanarQuadPolicyRollout(s["tenv"], B, 1, device="cpu")
    rows = s["rows"].clone()
    max_steps = int(fp1.params["max_steps"])
    rng = np.random.default_rng(2)
    rows[L["STEP"]] = torch.tensor(rng.integers(0, max_steps - 1, B), dtype=torch.float32)
    rows[L["STEP"], ::8] = max_steps - 1
    rows[0 if nx == 2 else 2, 4::8] = 2.6  # z above z_thr = 2.5: out-of-bound done
    new_rows, traj = fp1.run(rows, s["weights"], seed=11)
    d = fp1.unpack_traj(traj)

    vec = j_make_vec_env(s["jenv"], B)
    st, _, _ = jax.jit(vec.reset)(jax.random.key(0))
    off = st.dist_sched["dynamics"]["offsets"]
    j_diag = np.asarray(st.j_diag).copy()
    j_diag[:, 1] = rows[L["IYY"]].numpy()
    st = st.replace(
        x=jnp.asarray(rows[:nx].T.numpy()), mass=jnp.asarray(rows[L["MASS"]].numpy()),
        j_diag=jnp.asarray(j_diag), ctrl_step=jnp.asarray(rows[L["STEP"]].numpy().astype(np.int32)),
        dist_sched={**st.dist_sched, "dynamics": {
            **st.dist_sched["dynamics"],
            "offsets": jnp.asarray(rows[L["OFFSET"]].numpy().astype(np.int32)).reshape(off.shape)}})
    jst, jobs, jrew, jdone, jinfo = jax.jit(vec.step_no_reset)(st, jnp.asarray(d["act"][0].numpy()))
    done, trunc = d["done"][0].numpy() > 0, d["trunc"][0].numpy() > 0
    np.testing.assert_allclose(d["rew"][0].numpy(), np.asarray(jrew), rtol=2e-3, atol=1e-6)
    np.testing.assert_array_equal(done, np.asarray(jdone))
    np.testing.assert_array_equal(trunc, np.asarray(jinfo["TimeLimit.truncated"]))
    assert trunc.sum() >= B // 8 - 2 and (done & ~trunc).sum() >= B // 8 - 2
    live = ~done
    np.testing.assert_allclose(new_rows[:nx].T.numpy()[live], np.asarray(jst.x)[live],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(d["term_obs"][0].numpy()[trunc], np.asarray(jobs)[trunc],
                               rtol=2e-4, atol=2e-5)
    assert not d["term_obs"][0].numpy()[~trunc].any()
    viol = (new_rows[L["STATS"] + 2] - rows[L["STATS"] + 2]).numpy()[live]
    np.testing.assert_array_equal(viol, np.asarray(jinfo["constraint_violation"])[live])
    np.testing.assert_array_equal(new_rows[L["EP"]].numpy(), rows[L["EP"]].numpy() + done)


def test_plain_k8_step_is_k7_step(policy_setup):
    s = policy_setup
    p, d, nu = s["fp"].params, s["d"], s["nu"]
    carry = list(s["rows0"].unbind(0))
    for t in range(T):
        act = list(d["act"][t].T.unbind(0))
        carry, rew, done, _, _, _ = tf.step_rows(p, carry, [tf.preprocess(p, a) for a in act], act)
        assert torch.equal(rew, d["rew"][t]) and torch.equal(done.float(), d["done"][t])
    assert torch.equal(torch.stack(carry).view(torch.int32), s["rows"].view(torch.int32))
    assert nu == len(act)


def test_params_struct_mirrors_cuda_source():
    """PlanarParams lists the CUDA struct's fields in order, with the same
    types and array lengths (the kernels take it by value)."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(tf.__file__).parents[1] / "csrc" / "quad_planar.cuh").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct PlanarParams \{(.*?)\};", src, re.S).group(1))
    want = []
    for ctype, names in re.findall(r"\b(int|float|CurveParams)\s+([^;]+);", body):
        for decl in names.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\d+)\])?\s*", decl)
            want.append((m.group(1), ctype, int(m.group(2) or 1)))
    got = []
    for name, ct in tf.PlanarParams._fields_:
        base = ct._type_ if issubclass(ct, ctypes.Array) else ct
        ctype = {ctypes.c_int: "int", ctypes.c_float: "float"}.get(base, base.__name__)
        got.append((name, ctype, getattr(ct, "_length_", 1)))
    assert got == want


@pytest.mark.parametrize("group", tf.POLICY_GROUPS)
@pytest.mark.parametrize("hidden", [64, 128])
def test_kernels_match_plain_on_card(policy_setup, hidden, group):
    """K7 and K8 against their plain versions on the card, 25 steps through
    resets: rows and record at rtol 2e-4 / atol 2e-5, done counts exact; K8
    at H = 64 and 128 with action white noise (drawn ahead, actuated every
    step), at every group size it is built for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    s = policy_setup
    nx, nu = s["nx"], s["nu"]
    cfg = dict(CFG3, quad_type=s["fp"].env.config.quad_type, episode_len_sec=0.2)
    env = tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device=dev)
    fr = tf.FastPlanarQuadRollout(env, 1024, steps_per_call=25, device=dev)
    rows0, seed = fr.reset(seed=0), torch.tensor([5], dtype=torch.int32, device=dev)
    act = fr.prepare_action(np.full(nu, 1.2 * float(env.u_goal[0]), np.float32))
    out, ref = tf.planar_rollout(fr.params, rows0, act, seed), \
        tf.planar_rollout_plain(fr.params, rows0, act, seed)
    ex = tf.exact_rows(nx)
    assert torch.equal(out[ex], ref[ex])
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    noise = {"action": ({"disturbance_func": "white_noise", "std": 0.01},)}
    penv = tq.make_quadrotor(tq.QuadrotorConfig(**cfg, normalized_rl_action_space=True,
                                                disturbances=noise), device=dev)
    fp = tf.FastPlanarQuadPolicyRollout(penv, 1024, 25, mlp_hidden=hidden, device=dev)
    ac = (s["ac"] if hidden == 64 else
          ActorCritic(nx, nu, hidden, "tanh", generator=torch.Generator().manual_seed(0))).to(dev)
    w = fp.pack_weights(ac.actor, ac.critic, ac.logstd)
    assert fp.params["act_noise_std"] == 0.01
    rows, traj = tf.planar_policy_rollout(fp.params, rows0, w, seed, group=group)
    rows_p, traj_p = tf.planar_policy_rollout_plain(fp.params, rows0, w, seed)
    flags = [nx + nu + 1, nx + nu + 2]  # done and truncation records
    assert torch.equal(rows[ex], rows_p[ex]) and torch.equal(traj[:, flags], traj_p[:, flags])
    torch.testing.assert_close(rows, rows_p, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(traj, traj_p, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("batch", [1, 33, 1000, 4096, 16384])
@pytest.mark.parametrize("nx", [2, 6])
def test_launch_plan_covers_every_env_once(batch, nx):
    """K7's launch plan for each quad type stores every env exactly once,
    from one group inside one warp, at the group the plan picks and at each
    the source builds."""
    for group in (None, *tf.GROUPS):
        np.testing.assert_array_equal(lane_groups(tf.launch_plan(batch, nx, group), batch),
                                      np.arange(batch))
    assert tf.launch_plan(batch, nx)[0] == tf.FC.plan_group(batch, tf.PLAN_LANES, tf.GROUPS)
    with pytest.raises(ValueError):
        tf.launch_plan(batch, nx, 3)
    with pytest.raises(ValueError):
        tf.launch_plan(batch, 12)


def test_launch_plan_mirrors_cuda_source():
    """Each quad type's group sizes are the instances
    csrc/quad_planar_rollout.cu builds, its blocks fit the source's launch
    bound, and the entry point that takes the plan reports API version 2
    (scripts/ab_kernel.py tells the one-thread entry point apart by it)."""
    src = (Path(tf.__file__).parents[1] / "csrc" / "quad_planar_rollout.cu").read_text()
    built = re.findall(r"nx == (\d+) && group == (\d+)\) return launch<(\d+), \d+, (\d+)>", src)
    assert all(a == c and b == d for a, b, c, d in built)
    assert sorted((int(a), int(b)) for a, b, _, _ in built) == \
        [(nx, g) for nx in (2, 6) for g in tf.GROUPS]
    block = int(re.search(r"constexpr int BLOCK = (\d+);", src).group(1))
    assert all(tf.launch_plan(4096, 6, g)[1] <= block for g in tf.GROUPS)
    assert re.search(r"quad_planar_rollout_api_version\(\) \{ return 2; \}", src)
    from safe_control_gym_torch import kernels

    assert len(kernels._SIGNATURES["quad_planar_rollout"]) == 11  # ..., group, block, grid, stream


@pytest.mark.parametrize("batch", [1, 33, 1000, 4096, 16384])
@pytest.mark.parametrize("nx", [2, 6])
def test_policy_launch_plan_covers_every_env_once(batch, nx):
    """K8's launch plan for each quad type stores every env exactly once,
    from one group inside one warp, at the group the plan picks and at each
    the source builds."""
    for group in (None, *tf.POLICY_GROUPS):
        np.testing.assert_array_equal(
            lane_groups(tf.policy_launch_plan(batch, 64, nx, group), batch), np.arange(batch))
    assert tf.policy_launch_plan(batch, 64, nx)[0] == \
        tf.FC.plan_group(batch, tf.POLICY_PLAN_LANES, tf.POLICY_GROUPS)
    with pytest.raises(ValueError):
        tf.policy_launch_plan(batch, 64, nx, 3)
    with pytest.raises(ValueError):
        tf.policy_launch_plan(batch, 64, 12)


def test_policy_launch_plan_group_fits_the_lane_budget():
    """K8's plan takes the widest built group whose B x G lanes stay within
    POLICY_PLAN_LANES, and every group's shared-memory rows fit MAX_SMEM at
    the widest width."""
    for B in (1, 1000, 4096, 5000, 8192, 16384, 32768, 65536):
        for nx in (2, 6):
            g = tf.policy_launch_plan(B, 64, nx)[0]
            assert B * g <= tf.POLICY_PLAN_LANES or g == min(tf.POLICY_GROUPS), B
            assert all(B * h > tf.POLICY_PLAN_LANES for h in tf.POLICY_GROUPS if h > g), B
    assert tf.policy_launch_plan(4096, 64, 6)[0] == 8
    for group in tf.POLICY_GROUPS:
        G, block, _, smem = tf.policy_launch_plan(4096, 128, 6, group)
        assert smem == (block // G * tf.FP.group_row(128) * 4 if G > 1 else 0)
        assert smem <= tf.FP.MAX_SMEM


def test_policy_launch_plan_mirrors_cuda_source():
    """Each quad type's group sizes are the instances
    csrc/quad_planar_policy_rollout.cu builds, its blocks are the source's
    launch bound (32 envs), and the entry point that takes the plan reports
    API version 2 (scripts/ab_kernel.py tells the one-thread entry point
    apart by it)."""
    src = (Path(tf.__file__).parents[1] / "csrc" / "quad_planar_policy_rollout.cu").read_text()
    built = re.findall(r"nx == (\d+) && group == (\d+)\) return launch_width<(\d+), \d+, (\d+)>",
                       src)
    assert all(a == c and b == d for a, b, c, d in built)
    assert sorted((int(a), int(b)) for a, b, _, _ in built) == \
        [(nx, g) for nx in (2, 6) for g in tf.POLICY_GROUPS]
    assert "__launch_bounds__(32 * G," in src and "block != 32 * group" in src
    assert all(tf.policy_launch_plan(4096, 64, 6, g)[1] == 32 * g for g in tf.POLICY_GROUPS)
    assert re.search(r"quad_planar_policy_rollout_api_version\(\) \{ return 2; \}", src)
    from safe_control_gym_torch import kernels

    # ..., B, group, block, grid, smem, stream
    assert len(kernels._SIGNATURES["quad_planar_policy_rollout"]) == 15
