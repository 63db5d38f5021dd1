"""K5 and K6, the CartPole whole-rollout engines (``parallel/fast_cartpole.py``):
the plain versions against the JAX package's K5 (Pallas interpret mode), the
JAX package's policy and general engine, and the port's own general engine
through auto-resets; the action white noise in distribution; the CUDA
kernels against the plain versions on a card.

The TPU kernels' random bits cannot be replayed: the K5 comparisons run
noise-free configs, and the JAX side of the K6 checks is handed the port's
recorded observations and actions."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.ppo import ActorCritic
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs.disturbances import build_disturbances
from safe_control_gym_torch.ops import ctr_prng, philox
from safe_control_gym_torch.parallel import fast_cartpole as tf
from safe_control_gym_torch.parallel import rollout as tro
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers.ppo import PPO as JPPO
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.ops import ctr_prng as jp
from safe_control_gym_tpu.parallel import fast_cartpole as jf
from safe_control_gym_tpu.parallel.vector import make_vec_env as j_make_vec_env
from test_torch_fast_env import lane_groups  # csrc/lane_group_planar.cuh maps threads alike

B, T, SEED = 128, 8, 3
BOX = ({"constraint_form": "default_constraint", "constrained_variable": "state"},
       {"constraint_form": "bounded_constraint", "constrained_variable": "input",
        "lower_bounds": [-0.5], "upper_bounds": [0.5]})
CFG1 = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=10, task="stabilization",
            cost="rl_reward", randomized_init=True)
CFG2 = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=10, task="traj_tracking",
            randomized_init=True, done_on_out_of_bound=True,
            constraints=BOX[:1] + ({"constraint_form": "default_constraint",
                                    "constrained_variable": "input"},),
            disturbances={"action": ({"disturbance_func": "white_noise", "std": 0.2},)})
IMPULSE = {"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.4, "duration": 4,
                         "decay_rate": 0.8},)}
OBS_NOISE = {"observation": ({"disturbance_func": "white_noise", "std": 0.1},)}
# Noise-free configs for the step-exact comparisons.
_K5_VARIANTS = {
    "config1_short_episodes": (dict(CFG1, episode_len_sec=0.3), 1.5),
    "config2_noise_free_input_box": (dict(CFG2, disturbances=IMPULSE, constraints=BOX,
                                          randomized_inertial_prop=True, episode_len_sec=0.3), 0.8),
    "quadratic_square_tracking": (dict(CFG2, disturbances=None, cost="quadratic", episode_len_sec=0.3,
                                       q_weight=[1.0, 0.1, 1.0, 0.1], r_weight=[0.05],
                                       task_info={"trajectory_type": "square",
                                                  "trajectory_plane": "xz"}), -3.0),
    "quadratic_goal_capture": (dict(CFG1, cost="quadratic", task_info={
        "stabilization_goal": [0.0], "stabilization_goal_tolerance": 0.08}), 0.0),
}
_EXACT = tf._EXACT_ROWS


def _jax_seeds(seed=0, n=B):
    return np.asarray(jax.vmap(jp.env_seed_from_key)(jax.random.split(jax.random.key(seed), n)))


def _envs(cfg):
    return (jc.make_cartpole(jc.CartPoleConfig(**cfg)),
            tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu"))


def test_supports_envelope():
    assert tf.supports(tc.CartPoleConfig(**CFG2))
    assert tf.supports(tc.CartPoleConfig(**dict(CFG1, disturbances=IMPULSE)))
    bad = [dict(adversary_disturbance="dynamics"), dict(obs_goal_horizon=2),
           dict(done_on_violation=True), dict(normalized_rl_action_space=True),
           dict(disturbances={"observation": ({"disturbance_func": "white_noise",
                                                "std": [0.1, 0.1, 0.1, 0.1]},)}),
           dict(constraints=({"constraint_form": "linear_constraint",
                              "constrained_variable": "state", "A": [[1.0, 0, 1, 0]],
                              "b": [1.0]},))]
    for kw in bad:
        assert not tf.supports(tc.CartPoleConfig(**{**CFG1, **kw})), kw
    assert tf.supports(tc.CartPoleConfig(**CFG1, normalized_rl_action_space=True),
                       allow_normalized=True)
    # Scalar observation white noise: K5 admits it, and so does K6
    # (allow_normalized=True), which draws it; K6 has no goal-horizon rows,
    # as the JAX K6 (fast_cartpole.py:72).
    noisy = tc.CartPoleConfig(**CFG1, disturbances=OBS_NOISE)
    assert tf.supports(noisy)
    assert tf.supports(noisy, allow_normalized=True)
    assert not tf.supports(tc.CartPoleConfig(**CFG1, obs_goal_horizon=2), allow_normalized=True)


def test_obs_noise_leaves_k5_rows_unchanged():
    """Config 2 with and without scalar observation white noise: K5 never
    reads the observation, so the plain rows are bit-equal after 25 steps
    through resets and action noise."""
    rows = []
    for dist in (CFG2["disturbances"], {**CFG2["disturbances"], **OBS_NOISE}):
        env = tc.make_cartpole(tc.CartPoleConfig(**dict(CFG2, episode_len_sec=0.2,
                                                        disturbances=dist)), device="cpu")
        fr = tf.FastCartPoleRollout(env, B, steps_per_call=25, device="cpu")
        rows.append(fr.run(fr.reset(seed=0), 0.5, seed=7))
    assert float(rows[0][tf._R_STATS + 3].sum()) > 0
    assert torch.equal(rows[0].view(torch.int32), rows[1].view(torch.int32))


def test_k6_refuses_obs_noise():
    """K6 feeds the observation to the policy and draws a scalar
    observation white noise in-kernel; it refuses a masked or vector-std
    one, as the JAX package's does."""
    env = tc.make_cartpole(tc.CartPoleConfig(**CFG1, normalized_rl_action_space=True,
                                             disturbances=OBS_NOISE), device="cpu")
    fp = tf.FastCartPolePolicyRollout(env, 8, 2, device="cpu")
    assert fp.params["obs_noise_std"] == OBS_NOISE["observation"][0]["std"] and fp.obs_dim == 4
    for spec in ({"mask": [1, 0, 1, 0]}, {"std": [0.01] * 4}):
        dist = {"observation": ({**OBS_NOISE["observation"][0], **spec},)}
        cfg = dict(CFG1, normalized_rl_action_space=True, disturbances=dist)
        assert not jf.supports(jc.CartPoleConfig(**cfg), allow_normalized=True)
        with pytest.raises(ValueError, match="envelope"):
            tf.FastCartPolePolicyRollout(tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu"),
                                         8, 2, device="cpu")


def test_engine_params_and_reset_rows_match_jax():
    jenv, tenv = _envs(dict(CFG2, disturbances={**CFG2["disturbances"], **IMPULSE},
                            randomized_inertial_prop=True))
    jpar = jf.build_engine_params(jenv, 25, interpret=True)
    tpar = tf.build_engine_params(tenv, 25)
    for k, v in tpar.items():
        assert np.array_equal(np.asarray(v, dtype=object), np.asarray(jpar[k], dtype=object)), k
    jrows = np.asarray(jf.reset_rows(jpar, B, 1, B, seed=0)).reshape(18, B)
    trows = tf.reset_rows(tpar, torch.tensor(_jax_seeds(0))).numpy()
    np.testing.assert_array_equal(trows.view(np.int32), jrows.view(np.int32))


@pytest.mark.parametrize("variant", list(_K5_VARIANTS))
def test_plain_k5_matches_jax_kernel(variant):
    """25 steps from reset at B = 128: the plain K5 against the JAX
    package's K5 (Pallas interpret mode), with auto-resets in the window."""
    cfg, force = _K5_VARIANTS[variant]
    jenv, tenv = _envs(cfg)
    jfr = jf.FastCartPoleRollout(jenv, B, steps_per_call=25, sub=1, interpret=True)
    jrows = np.asarray(jfr.run(jfr.reset(seed=0), np.asarray([force]), seed=0)).reshape(18, B)
    tfr = tf.FastCartPoleRollout(tenv, B, steps_per_call=25, device="cpu")
    before = tf.cartpole_rollout.launches
    trows = tfr.run(tfr.reset(env_seeds=torch.tensor(_jax_seeds(0))), force).numpy()
    assert tf.cartpole_rollout.launches == before  # CPU: the plain version
    assert jrows[12].sum() > 0  # episodes ended inside the window
    np.testing.assert_array_equal(trows[_EXACT], jrows[_EXACT])
    np.testing.assert_array_equal(trows.view(np.int32)[16], jrows.view(np.int32)[16])
    np.testing.assert_allclose(trows[:4], jrows[:4], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(trows[4:7], jrows[4:7], rtol=1e-6)  # inertia
    np.testing.assert_allclose(trows[9:16], jrows[9:16], rtol=2e-4, atol=1e-5)  # stats
    assert tfr.stats(torch.from_numpy(trows))["episodes"] == jrows[12].sum()


def test_plain_k5_matches_general_engine_with_resets():
    """6-step episodes with impulse and randomized inertia, the same env
    seeds on both of the port's engines, 20 steps."""
    cfg = dict(CFG2, episode_len_sec=0.12, done_on_out_of_bound=False, disturbances=IMPULSE,
               randomized_inertial_prop=True)
    env = tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu")
    seeds = torch.tensor(_jax_seeds(0))
    fr = tf.FastCartPoleRollout(env, B, steps_per_call=20, device="cpu")
    rows0 = fr.reset(env_seeds=seeds)
    vec = make_vec_env(env, B)
    state, obs, _ = vec.reset(env_seeds=seeds)
    assert torch.equal(fr.pack(state).view(torch.int32), rows0.view(torch.int32))
    rows = fr.run(rows0, 0.5)
    act = torch.full((B, 1), 0.5)
    carry, _ = tro.rollout(vec, lambda ps, o: (act, ps),
                           tro.RolloutCarry(state, obs, (), tro.EpisodeStats.create(B)), 20,
                           collect=False)
    es = carry.env_state
    torch.testing.assert_close(fr.states(rows), es.x, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(rows[4], es.pole_length, rtol=1e-6, atol=0)
    assert torch.equal(rows[8], es.dist_offsets["dynamics"][:, 0].float())
    assert torch.equal(rows[17], es.episode_idx.float())
    assert torch.equal(rows[12], carry.stats.done_count.float())
    assert torch.equal(rows[7], es.ctrl_step.float())
    torch.testing.assert_close(rows[13], carry.stats.sum_return, rtol=2e-4, atol=1e-5)
    assert float(rows[12].sum()) == 3 * B


def test_action_white_noise_in_distribution():
    """1e5 draws.  The general engine's white noise (Philox keyed on env
    seed and episode, counted by step) and K5's (keyed on the call seed,
    counted by env and step, call site 1): mean within 4 standard errors of
    0, std within 2% of the configured 0.2, both engines' post-step cart
    velocities alike in distribution, and no overlap with the policy's
    call site 0 stream."""
    n = 100_000
    prog = build_disturbances(CFG2["disturbances"]["action"], 1, 10, 50, channel="action")
    es = ctr_prng.env_seeds_from_seed(0, n)
    noise = prog.apply(torch.zeros((n, 0), dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
                       torch.zeros((n, 1)), (es, torch.zeros_like(es)))[:, 0].double()
    assert abs(float(noise.mean())) < 4 * 0.2 / np.sqrt(n)
    assert abs(float(noise.std()) / 0.2 - 1) < 0.02
    again = prog.apply(torch.zeros((n, 0), dtype=torch.int32), torch.ones(n, dtype=torch.int32),
                       torch.zeros((n, 1)), (es, torch.zeros_like(es)))[:, 0].double()
    assert float((again == noise).double().mean()) < 1e-3  # a new draw each step

    env_ids = torch.arange(n)
    u1 = philox.uniforms(7, 0, env_ids, 2, philox.SITE_ACTION)
    u0 = philox.uniforms(7, 0, env_ids, 2, philox.SITE_POLICY)
    assert float((u1 == u0).double().mean()) < 1e-3
    eps = philox.box_muller(u1, 1)[0].double()
    assert abs(float(eps.mean())) < 4 / np.sqrt(n) and abs(float(eps.std()) - 1) < 0.02

    cfg = dict(CFG2, randomized_init=False, constraints=None)
    env = tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu")
    fr = tf.FastCartPoleRollout(env, n, steps_per_call=1, device="cpu")
    xdot_k5 = fr.run(fr.reset(seed=0), 0.0, seed=9)[1].double()
    state, _, _ = env.reset(es)
    xdot_gen = env.step(state, torch.zeros((n, 1)))[0].x[:, 1].double()
    for x in (xdot_k5, xdot_gen):
        assert abs(float(x.mean())) < 4 * float(x.std()) / np.sqrt(n)
    assert abs(float(xdot_k5.std() / xdot_gen.std()) - 1) < 0.03
    assert float(xdot_gen.std()) > 0


@pytest.fixture(scope="module")
def policy_setup():
    cfg = dict(CFG2, normalized_rl_action_space=True, disturbances=IMPULSE, constraints=BOX)
    jenv, tenv = _envs(cfg)
    jppo = JPPO(jenv, seed=0, rollout_batch_size=B, rollout_steps=T)
    jac = jax.device_get(jppo.state.ac)
    rng = np.random.default_rng(1)
    jac = jac.replace(
        actor_params=jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                  jac.actor_params),
        logstd=np.asarray([0.3], np.float32))  # wide: some actions clip, some break the box
    ac = ActorCritic(4, 1, 64, "tanh")
    convert.load_actor_critic(ac, jac.actor_params, jac.critic_params, jac.logstd)
    fp = tf.FastCartPolePolicyRollout(tenv, B, T, device="cpu")
    rows0 = fp.reset(env_seeds=torch.tensor(_jax_seeds(0)))
    weights = fp.pack_weights(ac.actor, ac.critic, ac.logstd)
    rows, traj = fp.run(rows0, weights, seed=SEED)
    return dict(jenv=jenv, tenv=tenv, jppo=jppo, jac=jac, ac=ac, fp=fp, rows0=rows0,
                weights=weights, rows=rows, traj=traj, d=fp.unpack_traj(traj))


def test_k6_record_shapes_and_finite(policy_setup):
    s = policy_setup
    d = s["d"]
    assert s["traj"].shape == (T, tf.TRAJ_ROWS, B)
    assert d["obs"].shape == (T, B, 4) and d["act"].shape == (T, B, 1)
    for k, v in d.items():
        assert torch.isfinite(v).all(), k
    assert ((d["rew"] > 0) & (d["rew"] <= 1)).all()
    np.testing.assert_array_equal(d["obs"][0].numpy(), s["rows0"][:4].T.numpy())
    assert torch.equal(s["fp"].observe(s["rows"]), s["rows"][:4].T)


def test_plain_k6_matches_jax_policy(policy_setup):
    """v and logp against the JAX critic and Gaussian actor on the recorded
    obs and act; act = mean + exp(logstd) eps, eps recomputed in float64
    NumPy from the port's Philox uniforms (draw 0 the radius, 1 the angle)."""
    s = policy_setup
    jppo, jac, d = s["jppo"], s["jac"], s["d"]
    obs, act = jnp.asarray(d["obs"].numpy()), jnp.asarray(d["act"].numpy())
    np.testing.assert_allclose(d["v"].numpy(), np.asarray(jppo._value(jac, obs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(d["logp"].numpy(), np.asarray(jppo._dist(jac, obs).log_prob(act)),
                               rtol=2e-3, atol=2e-3)
    mean = np.asarray(jppo._dist(jac, obs).loc, np.float64)
    eps = []
    for t in range(T):
        u = philox.uniforms(torch.tensor([SEED], dtype=torch.int32), t, torch.arange(B), 2)
        u = u.numpy().astype(np.float64)
        eps.append((np.sqrt(-2.0 * np.log(1.0 - u[:1])) * np.cos(2.0 * np.pi * u[1:])).T)
    want = mean + np.exp(np.asarray(jac.logstd, np.float64)) * np.stack(eps)
    np.testing.assert_allclose(d["act"].numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden", [32, 128])
def test_plain_k6_matches_jax_policy_at_width(policy_setup, hidden):
    """The plain K6 at hidden widths other than 64 (the kernel's
    run-time-width instance): recorded v and logp against the JAX package's
    critic and Gaussian actor of that width, weights carried by
    utils/convert.py (numpy-seeded noise on the actor)."""
    s = policy_setup
    nx, nu = 4, 1
    jppo = JPPO(s["jenv"], seed=0, rollout_batch_size=16, rollout_steps=4, hidden_dim=hidden)
    jac = jax.device_get(jppo.state.ac)
    rng = np.random.default_rng(hidden)
    jac = jac.replace(
        actor_params=jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                  jac.actor_params),
        logstd=np.linspace(-0.4, 0.1, nu).astype(np.float32))
    ac = ActorCritic(nx, nu, hidden, "tanh")
    convert.load_actor_critic(ac, jac.actor_params, jac.critic_params, jac.logstd)
    fp = tf.FastCartPolePolicyRollout(s["tenv"], 16, 4, mlp_hidden=hidden, device="cpu")
    _, traj = fp.run(fp.reset(seed=0), fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=SEED)
    d = fp.unpack_traj(traj)
    obs, act = jnp.asarray(d["obs"].numpy()), jnp.asarray(d["act"].numpy())
    np.testing.assert_allclose(d["v"].numpy(), np.asarray(jppo._value(jac, obs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(d["logp"].numpy(), np.asarray(jppo._dist(jac, obs).log_prob(act)),
                               rtol=2e-3, atol=2e-3)


def test_plain_k6_step_matches_jax_general_engine(policy_setup):
    """One K6 step from rows with spread control steps (some at the time
    limit) and some envs past the x threshold, against the JAX package's
    vec.step_no_reset on the same states and the recorded actions."""
    s = policy_setup
    fp1 = tf.FastCartPolePolicyRollout(s["tenv"], B, 1, device="cpu")
    rows = s["rows"].clone()
    max_steps = int(fp1.params["max_steps"])
    rng = np.random.default_rng(2)
    rows[7] = torch.tensor(rng.integers(0, max_steps - 1, B), dtype=torch.float32)
    rows[7, ::8] = max_steps - 1
    rows[0, 4::8] = 2.5  # past x_threshold = 2.4: out-of-bound done
    new_rows, traj = fp1.run(rows, s["weights"], seed=11)
    d = fp1.unpack_traj(traj)

    vec = j_make_vec_env(s["jenv"], B)
    st, _, _ = jax.jit(vec.reset)(jax.random.key(0))
    off = st.dist_sched["dynamics"]["offsets"]
    st = st.replace(
        x=jnp.asarray(rows[:4].T.numpy()), pole_length=jnp.asarray(rows[4].numpy()),
        pole_mass=jnp.asarray(rows[5].numpy()), cart_mass=jnp.asarray(rows[6].numpy()),
        ctrl_step=jnp.asarray(rows[7].numpy().astype(np.int32)),
        dist_sched={**st.dist_sched, "dynamics": {
            **st.dist_sched["dynamics"],
            "offsets": jnp.asarray(rows[8].numpy().astype(np.int32)).reshape(off.shape)}})
    jst, jobs, jrew, jdone, jinfo = jax.jit(vec.step_no_reset)(st, jnp.asarray(d["act"][0].numpy()))
    done, trunc = d["done"][0].numpy() > 0, d["trunc"][0].numpy() > 0
    np.testing.assert_allclose(d["rew"][0].numpy(), np.asarray(jrew), rtol=2e-3, atol=1e-6)
    np.testing.assert_array_equal(done, np.asarray(jdone))
    np.testing.assert_array_equal(trunc, np.asarray(jinfo["TimeLimit.truncated"]))
    assert trunc.sum() >= B // 8 - 2 and (done & ~trunc).sum() >= B // 8 - 2
    live = ~done
    np.testing.assert_allclose(new_rows[:4].T.numpy()[live], np.asarray(jst.x)[live],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(d["term_obs"][0].numpy()[trunc], np.asarray(jobs)[trunc],
                               rtol=2e-4, atol=2e-5)
    assert not d["term_obs"][0].numpy()[~trunc].any()
    viol = (new_rows[11] - rows[11]).numpy()[live]
    np.testing.assert_array_equal(viol, np.asarray(jinfo["constraint_violation"])[live])
    assert (new_rows[7].numpy()[done] == 0).all()
    np.testing.assert_array_equal(new_rows[17].numpy(), rows[17].numpy() + done)


def test_plain_k6_step_is_k5_step(policy_setup):
    """K6's env step is K5's: replaying the recorded actions through
    step_rows gives the same rows bit for bit."""
    s = policy_setup
    p, d = s["fp"].params, s["d"]
    carry = list(s["rows0"].unbind(0))
    for t in range(T):
        act = d["act"][t, :, 0]
        carry, rew, done, _, _, _ = tf.step_rows(p, carry, tf.preprocess(p, act), act)
        assert torch.equal(rew, d["rew"][t]) and torch.equal(done.float(), d["done"][t])
    assert torch.equal(torch.stack(carry).view(torch.int32), s["rows"].view(torch.int32))


def test_params_structs_mirror_cuda_source():
    """CartPoleParams and CurveParams list the CUDA structs' fields in order,
    with the same types and array lengths."""
    csrc = Path(tf.__file__).parents[1] / "csrc"
    for struct, header in ((tf.CartPoleParams, "cartpole.cuh"), (tf.CurveParams, "curve.cuh")):
        assert _ctypes_fields(struct) == _cuda_fields((csrc / header).read_text(), struct.__name__)


def _cuda_fields(src, name):
    body = re.sub(r"//[^\n]*", "", re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1))
    out = []
    for ctype, names in re.findall(r"\b(int|float|CurveParams)\s+([^;]+);", body):
        for decl in names.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\d+)\])?\s*", decl)
            out.append((m.group(1), ctype, int(m.group(2) or 1)))
    return out


def _ctypes_fields(struct):
    import ctypes

    out = []
    for name, ct in struct._fields_:
        base = ct._type_ if issubclass(ct, ctypes.Array) else ct
        ctype = {ctypes.c_int: "int", ctypes.c_float: "float"}.get(base, base.__name__)
        out.append((name, ctype, getattr(ct, "_length_", 1)))
    return out


def test_wrappers_reject_tensors_off_cpu_and_cuda(policy_setup):
    m = lambda *s, dt=torch.float32: torch.empty(*s, device="meta", dtype=dt)  # noqa: E731
    p = policy_setup["fp"].params
    with pytest.raises(ValueError):
        tf.cartpole_rollout(p, m(18, 4), m(1, 4), m(1, dt=torch.int32))
    with pytest.raises(ValueError):
        tf.cartpole_policy_rollout(p, m(18, 4), [m(*sh) for sh in tf.policy_shapes(4, 1, 128)],
                                   m(1, dt=torch.int32))


@pytest.mark.parametrize("group", tf.POLICY_GROUPS)
@pytest.mark.parametrize("hidden", [64, 128])
def test_kernels_match_plain_on_card(policy_setup, hidden, group):
    """K5 and K6 against their plain versions on the card, 25 steps through
    resets, config 2 with its action white noise: rows and record at rtol
    2e-4 / atol 2e-5, done counts exact; K6 at H = 64 and 128, at every
    group size it is built for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    env = tc.make_cartpole(tc.CartPoleConfig(**{**CFG2, "episode_len_sec": 0.2}), device=dev)
    fr = tf.FastCartPoleRollout(env, 1024, steps_per_call=25, device=dev)
    rows0, seed = fr.reset(seed=0), torch.tensor([5], dtype=torch.int32, device=dev)
    act = fr.prepare_action(0.3)
    out, ref = tf.cartpole_rollout(fr.params, rows0, act, seed), \
        tf.cartpole_rollout_plain(fr.params, rows0, act, seed)
    assert torch.equal(out[_EXACT], ref[_EXACT]) and float(out[12].sum()) > 0
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    penv = tc.make_cartpole(tc.CartPoleConfig(**{**CFG2, "episode_len_sec": 0.2,
                                                 "normalized_rl_action_space": True}), device=dev)
    fp = tf.FastCartPolePolicyRollout(penv, 1024, 25, mlp_hidden=hidden, device=dev)
    ac = (policy_setup["ac"] if hidden == 64 else
          ActorCritic(4, 1, hidden, "tanh", generator=torch.Generator().manual_seed(0))).to(dev)
    w = fp.pack_weights(ac.actor, ac.critic, ac.logstd)
    assert fp.params["act_noise_std"] == 0.2
    rows, traj = tf.cartpole_policy_rollout(fp.params, rows0, w, seed, group=group)
    rows_p, traj_p = tf.cartpole_policy_rollout_plain(fp.params, rows0, w, seed)
    assert torch.equal(rows[12], rows_p[12]) and torch.equal(traj[:, 6:8], traj_p[:, 6:8])
    torch.testing.assert_close(rows, rows_p, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(traj, traj_p, rtol=2e-4, atol=2e-5)


def test_engine_takes_config2_and_refuses_the_goal_horizon():
    env = tc.make_cartpole(tc.CartPoleConfig(**CFG2), device="cpu")
    assert tf.FastCartPoleRollout(env, 8, steps_per_call=3, device="cpu").params[
        "act_noise_std"] == 0.2
    horizon = tc.make_cartpole(tc.CartPoleConfig(**{**CFG2, "obs_goal_horizon": 1}), device="cpu")
    with pytest.raises(ValueError):
        tf.build_engine_params(horizon, 3)


@pytest.mark.parametrize("batch", [1, 33, 1000, 4096, 16384])
def test_launch_plan_covers_every_env_once(batch):
    """K5's launch plan stores every env exactly once, from one group inside
    one warp, at the group the plan picks and at each the source builds."""
    for group in (None, *tf.GROUPS):
        np.testing.assert_array_equal(lane_groups(tf.launch_plan(batch, group), batch),
                                      np.arange(batch))
    with pytest.raises(ValueError):
        tf.launch_plan(batch, 3)


def test_launch_plan_group_fits_the_lane_budget():
    """The plan takes the widest built group whose B x G lanes stay within
    PLAN_LANES: 4 lanes an env at the main path's B = 4096, one thread an
    env at B = 65536."""
    for B in (1, 1000, 4096, 5000, 8192, 16384, 65536):
        g = tf.launch_plan(B)[0]
        assert B * g <= tf.PLAN_LANES or g == min(tf.GROUPS), B
        assert all(B * h > tf.PLAN_LANES for h in tf.GROUPS if h > g), B
    assert tf.launch_plan(4096)[0] == 4 and tf.launch_plan(65536)[0] == 1


def test_launch_plan_mirrors_cuda_source():
    """The plan's group sizes are the instances csrc/cartpole_rollout.cu
    builds, its blocks fit the source's launch bound, and the entry point
    that takes the plan reports API version 2 (scripts/ab_kernel.py tells
    the one-thread entry point apart by it)."""
    src = (Path(tf.__file__).parents[1] / "csrc" / "cartpole_rollout.cu").read_text()
    built = re.findall(r"if \(group == (\d+)\) return launch<(\d+)>", src)
    assert all(a == b for a, b in built) and sorted(int(a) for a, _ in built) == list(tf.GROUPS)
    block = int(re.search(r"constexpr int BLOCK = (\d+);", src).group(1))
    assert all(tf.launch_plan(4096, g)[1] <= block for g in tf.GROUPS)
    assert re.search(r"cartpole_rollout_api_version\(\) \{ return 2; \}", src)
    from safe_control_gym_torch import kernels

    assert len(kernels._SIGNATURES["cartpole_rollout"]) == 10  # ..., B, group, block, grid, stream


@pytest.mark.parametrize("batch", [1, 33, 1000, 4096, 16384])
def test_policy_launch_plan_covers_every_env_once(batch):
    """K6's launch plan stores every env exactly once, from one group inside
    one warp, at the group the plan picks and at each the source builds."""
    for group in (None, *tf.POLICY_GROUPS):
        np.testing.assert_array_equal(lane_groups(tf.policy_launch_plan(batch, 64, group), batch),
                                      np.arange(batch))
    with pytest.raises(ValueError):
        tf.policy_launch_plan(batch, 64, 3)
    with pytest.raises(ValueError):
        tf.policy_launch_plan(batch, 129)


def test_policy_launch_plan_group_fits_the_lane_budget():
    """K6's plan takes the widest built group whose B x G lanes stay within
    POLICY_PLAN_LANES: 8 lanes an env at the training path's B = 4096, one
    thread an env at B = 65536."""
    for B in (1, 1000, 4096, 5000, 8192, 16384, 32768, 65536):
        g = tf.policy_launch_plan(B, 64)[0]
        assert B * g <= tf.POLICY_PLAN_LANES or g == min(tf.POLICY_GROUPS), B
        assert all(B * h > tf.POLICY_PLAN_LANES for h in tf.POLICY_GROUPS if h > g), B
    assert tf.policy_launch_plan(4096, 64)[0] == 8 and tf.policy_launch_plan(65536, 64)[0] == 1


@pytest.mark.parametrize("hidden", [1, 63, 64, 128])
def test_policy_launch_plan_shared_memory_fits(hidden):
    """A group of lanes gets a shared-memory row per env
    (lane_group.cuh::mlp_group_row, what the entry point checks) within
    MAX_SMEM, the widest width included; one lane an env needs none."""
    for group in tf.POLICY_GROUPS:
        G, block, _, smem = tf.policy_launch_plan(4096, hidden, group)
        assert smem == (block // G * tf.FP.group_row(hidden) * 4 if G > 1 else 0)
        assert smem <= tf.FP.MAX_SMEM


def test_policy_launch_plan_mirrors_cuda_source():
    """The plan's group sizes are the instances csrc/cartpole_policy_rollout.cu
    builds, its blocks are the source's launch bound (32 envs), and the
    entry point that takes the plan reports API version 2
    (scripts/ab_kernel.py tells the one-thread entry point apart by it)."""
    src = (Path(tf.__file__).parents[1] / "csrc" / "cartpole_policy_rollout.cu").read_text()
    built = re.findall(r"if \(group == (\d+)\) return launch_width<(\d+)>", src)
    assert all(a == b for a, b in built) and sorted(int(a) for a, _ in built) == \
        list(tf.POLICY_GROUPS)
    assert "__launch_bounds__(32 * G," in src and "block != 32 * group" in src
    assert all(tf.policy_launch_plan(4096, 128, g)[1] == 32 * g for g in tf.POLICY_GROUPS)
    assert re.search(r"cartpole_policy_rollout_api_version\(\) \{ return 2; \}", src)
    from safe_control_gym_torch import kernels

    # ..., B, group, block, grid, smem, stream
    assert len(kernels._SIGNATURES["cartpole_policy_rollout"]) == 14


def test_one_thread_steps_are_gone():
    """The CartPole and planar-quad steps exist once, as the grouped steps
    of csrc/lane_group_planar.cuh: no source defines or calls the one-thread
    cp::env_step or pq::env_step."""
    csrc = Path(tf.__file__).parents[1] / "csrc"
    for name in ("cartpole.cuh", "quad_planar.cuh", "lane_group_planar.cuh"):
        assert not re.search(r"\benv_step\s*\(", (csrc / name).read_text()), name
    for path in csrc.iterdir():
        assert not re.search(r"\b(cp|pq)::env_step\b", path.read_text()), path.name
    src = (csrc / "lane_group_planar.cuh").read_text()
    assert re.search(r"void cp_step\(", src) and re.search(r"bool pq_step\(", src)
