"""K3's maze build (``parallel/fast_policy.py`` with ``fast_env.step_rows``'
maze step, BASELINE config 5): the plain K3 against the JAX package's K3
in Pallas interpret mode from the same rows, with envs placed in a gate's
aperture, at an obstacle, on the ground and at the goal so that gate
passes, collisions and completions occur; its step noise against the JAX
forms in distribution; ``supports(allow_maze=True)`` of the policy engine
against the JAX package's; the PPO trainer's refusal of the maze.

Tolerances: rows and records rtol 2e-4 / atol 2e-5 (tests/test_fast_env.py:
85), the done, truncation, step, episode and maze rows exact; the step
noise in distribution only (4096 envs: means within 4 standard errors,
stds within 10%), since the port's Philox draws are not the TPU's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.ppo import PPO as TPPO
from safe_control_gym_torch.controllers.ppo import ActorCritic
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel import fast_env as tf
from safe_control_gym_torch.parallel import fast_policy as tp
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers.ppo import PPO as JPPO
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.parallel import fast_env as jf
from safe_control_gym_tpu.parallel.fast_policy import FastPolicyRollout as JFastPolicyRollout
from tests.test_torch_maze import _SUPPORT_TABLE, NOISE, _config5

B, T, SEED = 128, 4, 5
# Config 5 with the normalized action space and completion done, no step
# noise (the packages' draws differ).
MAZE = dict(normalized_rl_action_space=True, done_on_completion=True, disturbances=None)
NG, NO = 4, 4
MZ = 27 + 4 * NG + 2 * NO  # the counter rows: current gate, steps at goal, completed, violation
# Placed envs: in gate 0's aperture, at an obstacle (collision), below the
# ground's collision height, at the goal one step from completion.
GATE, OBST, GROUND, GOAL = slice(0, 16), slice(16, 32), slice(32, 40), slice(40, 56)


def _envs(**kw):
    cfg = _config5(**{**MAZE, **kw})
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg, use_pallas=False)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


def _ac(obs_dim=12, logstd=-20.0, seed=0):
    """A seeded actor-critic with numpy-seeded noise on the actor (its
    output gain is 0.01) and the given logstd: at -20 both packages' actions
    are their means, whatever their random bits."""
    ac = ActorCritic(obs_dim, 4, 64, "tanh", generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for prm in ac.actor.parameters():
            prm.add_(torch.from_numpy(0.05 * rng.standard_normal(prm.shape).astype(np.float32)))
        ac.logstd.fill_(logstd)
    return ac


def _placed(rows, p, goal_xyz):
    """The rows (n_rows, B) with the placed envs, all at step 40 (past the
    settling window, clear of the time limit), at rest and level."""
    r = rows.copy()
    r[16] = 40.0
    for sl, (x, y, z) in ((GATE, (r[27], r[28], r[30])), (OBST, (r[27 + 4 * NG], r[28 + 4 * NG],
                                                                  np.full(B, 0.5, np.float32))),
                          (GROUND, (r[0], r[2], np.full(B, 0.005, np.float32))),
                          (GOAL, [np.full(B, v, np.float32) for v in goal_xyz])):
        r[:12, sl] = 0.0
        r[0, sl], r[2, sl], r[4, sl] = x[sl], y[sl], z[sl]
    r[MZ, GOAL] = NG
    r[MZ + 1, GOAL] = p["completion_steps"]
    return r


@pytest.fixture(scope="module")
def maze():
    """The JAX K3 (interpret mode, sub = 1) and the plain K3 on config 5
    without step noise, T steps from the same placed rows and weights."""
    jenv, tenv = _envs()
    ac = _ac()
    jfp = JFastPolicyRollout(jenv, B, T, sub=1, interpret=True)
    fp = tp.FastPolicyRollout(tenv, B, T, device="cpu")
    rows0 = _placed(np.asarray(jfp.reset(0)).reshape(-1, B), fp.params, fp.params["goal_xyz"])
    actor, critic, logstd = convert.actor_critic_params(ac)
    jw = jfp.pack_weights(actor, critic, logstd)
    jout, jtraj = jfp.run(jnp.asarray(rows0.reshape(-1, 1, B)), jw, seed=SEED)
    rows, traj = fp.run(torch.from_numpy(rows0), fp.pack_weights(ac.actor, ac.critic, ac.logstd),
                        seed=SEED)
    return dict(jfp=jfp, fp=fp, rows0=rows0, jrows=np.asarray(jout).reshape(-1, B),
                jd={k: np.asarray(v) for k, v in jfp.unpack_traj(jtraj).items()},
                rows=rows.numpy(), d={k: v.numpy() for k, v in fp.unpack_traj(traj).items()})


def test_plain_k3_maze_matches_jax_kernel(maze):
    """Rows and records of the plain K3 against the JAX K3's: the step,
    offset, done-count, episode rows, the gate heights and the maze's
    counters exact; the redrawn poses within one float32 ulp (the jitted
    JAX kernel contracts the reset affine ``a + u * b`` into an FMA on the
    CPU, the plain version rounds twice: tests/test_torch_maze.py's pose
    check); the states and statistics at the suite's tolerances; every
    record field but the log-prob (it holds each package's own Gaussian
    draws) at rtol 2e-4 / atol 2e-5, done and truncation exact."""
    rows, jrows, d, jd = maze["rows"], maze["jrows"], maze["d"], maze["jd"]
    assert rows.shape == jrows.shape == (MZ + 4, B)
    heights = [27 + 4 * g + 3 for g in range(NG)]
    exact = [16, 17, 21, 26] + heights + list(range(MZ, MZ + 4))
    np.testing.assert_array_equal(rows[exact], jrows[exact])
    np.testing.assert_array_equal(rows.view(np.int32)[25], jrows.view(np.int32)[25])
    a, _ = tf.pose_affine(maze["fp"].params)
    pose = [27 + 4 * g + j for g in range(NG) for j in range(3)] + list(range(27 + 4 * NG, MZ))
    for q, k in enumerate(pose):
        ulp = np.spacing(np.abs(np.float32(a[q]))) + np.spacing(np.abs(jrows[k]))
        assert (np.abs(rows[k] - jrows[k]) <= ulp).all(), k
    np.testing.assert_allclose(rows[:16], jrows[:16], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(rows[18:25], jrows[18:25], rtol=2e-4, atol=1e-5)
    for k in ("done", "trunc"):
        np.testing.assert_array_equal(d[k], jd[k], err_msg=k)
    for k in ("obs", "act", "rew", "v", "term_obs"):
        np.testing.assert_allclose(d[k], jd[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert np.isfinite(d["logp"]).all()


def test_placed_envs_pass_collide_and_complete(maze):
    """The placed envs do what they were placed for in the first step: the
    gate envs pass gate 0 (+100), the obstacle and ground envs collide
    (-1000, done, reset with redrawn poses), the goal envs complete (+100 at
    the goal, done)."""
    rows0, d = maze["rows0"], maze["d"]
    rew, done = d["rew"][0], d["done"][0]
    assert (rew[GATE] == 100.0).all() and not done[GATE].any()
    assert (rew[OBST] == -1000.0).all() and done[OBST].all()
    assert (rew[GROUND] == -1000.0).all() and done[GROUND].all()
    assert (rew[GOAL] == 100.0).all() and done[GOAL].all()
    rows = maze["rows"]
    assert (rows[MZ, GATE] >= 1).all()
    redrawn = (rows[27:27 + 4 * NG, OBST] != rows0[27:27 + 4 * NG, OBST]).any(0)
    assert redrawn.all() and (rows[26, OBST] == rows0[26, OBST] + 1).all()


def test_k3_maze_step_is_k2_maze_step():
    """K3's maze step is K2's: replaying K3's recorded (pre-noise) actions
    through fast_env.step_rows with the call's step noise (Philox sites 1
    and 3) gives K3's rows bit for bit, on config 5 with its noise."""
    _, tenv = _envs(disturbances=NOISE)
    fp = tp.FastPolicyRollout(tenv, 64, 3, device="cpu")
    p, ac = fp.params, _ac(logstd=-1.0)
    rows0 = fp.reset(seed=2)
    rows, traj = fp.run(rows0, fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=9)
    d = fp.unpack_traj(traj)
    carry, env = list(rows0.unbind(0)), torch.arange(64)
    for t in range(3):
        act = list(d["act"][t].T.unbind(0))
        thr = [(1.0 + p["norm_act_scale"] * torch.clamp(a, -1.0, 1.0)) * p["hover_thrust"]
               for a in act]
        seed = torch.tensor([9], dtype=torch.int32)
        carry, rew, done, _, _, _ = tf.step_rows(p, carry, thr, act, tf.step_noise(p, seed, t, env))
        assert torch.equal(rew, d["rew"][t]) and torch.equal(done.float(), d["done"][t])
    assert torch.equal(torch.stack(carry).view(torch.int32), rows.view(torch.int32))


def test_k3_maze_step_noise_matches_jax_in_distribution():
    """One step of the plain K3 on config 5 with its step noise (action white
    noise of std 0.001 and the uniform force of +-0.1 N) against the JAX
    package's step_env_core on the same rows and thrust with jax.random
    draws in its forms: the velocity change that the noise adds (against
    the same step without noise) has the same mean and std on each axis
    over 4096 envs (means within 4 standard errors, stds within 10%)."""
    n = 4096
    jenv, tenv = _envs(disturbances=NOISE)
    _, tclean = _envs()
    fp = tp.FastPolicyRollout(tenv, n, 1, device="cpu")
    ac = _ac(logstd=-20.0)
    rows0 = fp.reset(seed=4)
    rows, traj = fp.run(rows0, fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=3)
    act = fp.unpack_traj(traj)["act"][0].T
    p = fp.params
    thr = [(1.0 + p["norm_act_scale"] * torch.clamp(a, -1.0, 1.0)) * p["hover_thrust"] for a in act]
    pc = tf.build_engine_params(tclean, 1, allow_normalized=True, allow_maze=True)
    clean = torch.stack(tf.step_rows(pc, list(rows0.unbind(0)), thr, list(act))[0])
    jp = jf.build_engine_params(jenv, 1, interpret=True, allow_normalized=True, allow_maze=True)
    keys = iter(jax.random.split(jax.random.key(0), 8))

    def draw(k, salt):
        return jax.random.uniform(next(keys), (k, n), jnp.float32)

    jout = jf.step_env_core(jp, tuple(jnp.asarray(r) for r in rows0.numpy()),
                            [jnp.asarray(t.numpy()) for t in thr], 0, draw,
                            act_rows=[jnp.asarray(a.numpy()) for a in act])[0]
    jrows = np.stack([np.asarray(r) for r in jout])
    live = ~(rows[21] > rows0[21]).numpy() & ~(jrows[21] > rows0[21].numpy())
    assert live.mean() > 0.9
    for k in (1, 3, 5):
        dv_t = (rows[k] - clean[k]).double().numpy()[live]
        dv_j = (jrows[k] - clean[k].numpy()).astype(float)[live]
        se = np.hypot(dv_t.std(), dv_j.std()) / np.sqrt(live.sum())
        assert abs(dv_t.mean() - dv_j.mean()) < 4 * se, k
        assert abs(dv_t.std() / dv_j.std() - 1) < 0.1, k
        assert dv_t.std() > 0


_POLICY_TABLE = {
    **_SUPPORT_TABLE,
    "normalized": dict(normalized_rl_action_space=True),
    "goal_rows_with_gates": dict(cost="rl_reward", obs_goal_horizon=2),
    "goal_rows_with_competition": dict(obs_goal_horizon=2),
    "goal_rows_above_the_obs_cap": dict(cost="rl_reward", task="traj_tracking",
                                        task_info={"trajectory_type": "figure8"},
                                        obs_goal_horizon=10),
    "obs_noise_and_goal_rows": dict(cost="rl_reward", obs_goal_horizon=1, disturbances={
        **NOISE, "observation": ({"disturbance_func": "white_noise", "std": 0.01},)}),
}


@pytest.mark.parametrize("case", sorted(_POLICY_TABLE))
def test_policy_supports_maze_envelope_matches_jax(case):
    """The policy engine's envelope (``supports(allow_normalized=True,
    allow_maze=True, allow_goal_horizon=True)``, what FastPolicyRollout asks
    for) against the JAX K3's (fast_policy.py:236-237), case by case:
    equal but above the port's caps (8 gates, 8 obstacles, an observation of
    128 rows), which the JAX kernel takes and the port refuses; and
    FastPolicyRollout builds exactly where the port's supports holds."""
    cfg = _config5(**_POLICY_TABLE[case])
    flags = dict(allow_normalized=True, allow_maze=True, allow_goal_horizon=True)
    got = tf.supports(tq.QuadrotorConfig(**cfg), **flags)
    want = jf.supports(jq.QuadrotorConfig(**cfg), **flags)
    if "above_the" in case:
        assert want and not got
    else:
        assert got == want
    if got:
        env = tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu")
        fp = tp.FastPolicyRollout(env, 8, 2, device="cpu")
        assert fp.n_rows == tf.total_rows(fp.params)
        assert fp.obs_dim == 12 * tf.obs_mul(env.config)
    else:  # quad_2d's env itself refuses config 5's 3D uniform force
        with pytest.raises(ValueError):
            tp.FastPolicyRollout(tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"), 8, 2,
                                 device="cpu")


def test_maze_with_obs_noise_and_goal_rows_runs():
    """The maze with the observation instance's rows (noise and a goal
    block, rl_reward cost), a quarter of the envs two steps from the time
    limit: the record holds obs 24 wide, the goal block is the static goal
    (in the terminal observation of truncated steps too), the maze rows
    move through collision resets, and the plain K3 is deterministic in its
    seed."""
    cfg = _POLICY_TABLE["obs_noise_and_goal_rows"]
    _, tenv = _envs(**cfg)
    fp = tp.FastPolicyRollout(tenv, 64, 40, device="cpu")
    assert fp.obs_dim == 24 and tp.obs_ext(fp.params, 12) is not None
    ac = _ac(obs_dim=24, logstd=-1.0)
    w = fp.pack_weights(ac.actor, ac.critic, ac.logstd)
    rows0 = fp.reset(seed=1)
    rows0[16, ::4] = fp.params["max_steps"] - 2
    rows, traj = fp.run(rows0, w, seed=4)
    d = fp.unpack_traj(traj)
    assert torch.isfinite(traj).all() and d["obs"].shape == (40, 64, 24)
    goal = torch.tensor(np.asarray(tenv.x_goal, np.float32))
    assert torch.equal(d["obs"][:, :, 12:], goal.expand(40, 64, 12))
    trunc = d["trunc"] > 0
    assert float(d["done"].sum()) > trunc.sum() > 0
    assert torch.equal(d["term_obs"][trunc][:, 12:], goal.expand(int(trunc.sum()), 12))
    assert not torch.equal(rows[27:MZ], rows0[27:MZ])
    again = fp.run(rows0, w, seed=4)
    assert torch.equal(again[1], traj) and torch.equal(again[0], rows)


def test_ppo_refuses_the_maze_for_k3():
    """The PPO trainer sends no maze config to K3, as the JAX PPO asserts
    supports(...) without allow_maze (controllers/ppo.py:207-210), though
    FastPolicyRollout itself takes config 5."""
    jenv, tenv = _envs()
    with pytest.raises(ValueError, match="supports"):
        TPPO(tenv, use_fast_rollout=True, rollout_batch_size=8, rollout_steps=2)
    with pytest.raises(AssertionError):
        JPPO(jenv, use_fast_rollout=True, rollout_batch_size=8, rollout_steps=2)
    assert tp.FastPolicyRollout(tenv, 8, 2, device="cpu").params["maze"]
    TPPO(tenv, use_fast_rollout=False, rollout_batch_size=8, rollout_steps=2)


def test_maze_instance_choice():
    """Configs with the maze or step noise run the maze instances; config 4
    keeps its state-observation instance."""
    from safe_control_gym_torch.baseline import cfg4

    _, tenv = _envs()
    assert tp.maze_instance(tp.FastPolicyRollout(tenv, 8, 2, device="cpu").params)
    c4 = tq.make_quadrotor(dataclasses.replace(cfg4(), normalized_rl_action_space=True),
                           device="cpu")
    assert not tp.maze_instance(tp.FastPolicyRollout(c4, 8, 2, device="cpu").params)


def test_maze_entry_mirrors_cuda_source():
    """The maze entry point's ctypes signature is the observation entry's
    and the CUDA source builds the three maze instances, API version 3."""
    import re
    from pathlib import Path

    from safe_control_gym_torch import kernels

    src = (Path(tp.__file__).parents[1] / "csrc" / "quad3d_policy_rollout.cu").read_text()
    assert kernels._SIGNATURES["quad3d_policy_rollout_maze"] == \
        kernels._SIGNATURES["quad3d_policy_rollout_obs"]
    assert re.search(r"quad3d_policy_rollout_api_version\(\) \{ return 3; \}", src)
    for inst in ("launch<0, K3_GROUP, true, true>", "launch<64, K3_GROUP, false, true>",
                 "launch<0, K3_GROUP, false, true>"):
        assert inst in src


@pytest.mark.parametrize("hidden", [64, 128])
def test_maze_kernel_matches_plain_on_card(hidden):
    """K3's maze instances against their plain version on the card, config 5
    with its step noise, 25 steps through collision resets: rows and record
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    from safe_control_gym_torch.baseline import cfg5

    env = tq.make_quadrotor(cfg5(normalized_rl_action_space=True, episode_len_sec=4), device=dev)
    fp = tp.FastPolicyRollout(env, 1000, 25, mlp_hidden=hidden, device=dev)
    rows0 = fp.reset(seed=0)
    ac = ActorCritic(12, 4, hidden, "tanh", generator=torch.Generator().manual_seed(0)).to(dev)
    w = fp.pack_weights(ac.actor, ac.critic, ac.logstd)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    rows, traj = tp.policy_rollout(fp.params, rows0, w, seed)
    rows_p, traj_p = tp.policy_rollout_plain(fp.params, rows0, w, seed)
    torch.cuda.synchronize()
    assert rows[21].sum() > 0
    assert torch.equal(rows.view(torch.int32), rows_p.view(torch.int32))
    assert torch.equal(traj.view(torch.int32), traj_p.view(torch.int32))
