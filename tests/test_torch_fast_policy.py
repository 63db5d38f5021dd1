"""K3, the policy-in-kernel rollout (``parallel/fast_policy.py``), and the
Philox generator it draws from (``ops/philox.py``): the plain version
against the JAX package's networks and general engine on the same weights,
rows and actions, and the CUDA kernel against the plain version on a card.

Config: BASELINE config 4 with the normalized RL action space (the
``rl_train`` workload).  The TPU kernel's random bits cannot be replayed,
so the JAX side is handed the port's recorded observations and actions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.ppo import ActorCritic
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.ops import philox
from safe_control_gym_torch.parallel import fast_env as tf
from safe_control_gym_torch.parallel import fast_policy as tp
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers.ppo import PPO as JPPO
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.parallel import fast_env as jf
from safe_control_gym_tpu.parallel.vector import make_vec_env as j_make_vec_env

B, T, SEED = 128, 8, 3
CFG = dict(
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
    done_on_out_of_bound=True, normalized_rl_action_space=True,
)


@pytest.fixture(scope="module")
def setup():
    jenv = jq.make_quadrotor(jq.QuadrotorConfig(**CFG))
    tenv = tq.make_quadrotor(tq.QuadrotorConfig(**CFG), device="cpu")
    jppo = JPPO(jenv, seed=0, rollout_batch_size=B, rollout_steps=T)
    jac = jax.device_get(jppo.state.ac)
    # Perturb the fresh init so every layer carries signal (the actor's
    # output gain is 0.01) and logstd is not uniform.
    rng = np.random.default_rng(1)
    jac = jac.replace(
        actor_params=jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                  jac.actor_params),
        logstd=np.asarray([-0.5, -0.7, -0.3, -0.6], np.float32))
    ac = ActorCritic(12, 4, 64, "tanh")
    convert.load_actor_critic(ac, jac.actor_params, jac.critic_params, jac.logstd)
    fp = tp.FastPolicyRollout(tenv, B, T, device="cpu")
    rows0 = fp.reset(seed=0)
    weights = fp.pack_weights(ac.actor, ac.critic, ac.logstd)
    rows, traj = fp.run(rows0, weights, seed=SEED)
    return dict(jenv=jenv, tenv=tenv, jppo=jppo, jac=jac, ac=ac, fp=fp, rows0=rows0,
                weights=weights, rows=rows, traj=traj, d=fp.unpack_traj(traj))


def test_record_shapes_and_finite(setup):
    d, fp = setup["d"], setup["fp"]
    assert setup["traj"].shape == (T, tp.TRAJ_ROWS, B)
    assert d["obs"].shape == (T, B, 12) and d["act"].shape == (T, B, 4)
    assert d["term_obs"].shape == (T, B, 12)
    for k in ("rew", "done", "trunc", "v", "logp", "mask"):
        assert d[k].shape == (T, B), k
    for k, v in d.items():
        assert torch.isfinite(v).all(), k
    assert ((d["rew"] > 0) & (d["rew"] <= 1)).all()  # exponential reward
    # Step t's obs is the state the previous step left (no resets here).
    np.testing.assert_array_equal(d["obs"][0].numpy(), setup["rows0"][:12].T.numpy())
    np.testing.assert_array_equal(fp.observe(setup["rows"]).numpy(), setup["rows"][:12].T.numpy())


def test_value_and_logp_match_jax_policy(setup):
    """Recorded v and logp against the JAX package's critic and Gaussian
    actor on the recorded obs and act (tolerances of
    tests/test_fast_policy.py: the kernel's sums run in input order)."""
    jppo, jac, d = setup["jppo"], setup["jac"], setup["d"]
    obs, act = jnp.asarray(d["obs"].numpy()), jnp.asarray(d["act"].numpy())
    np.testing.assert_allclose(d["v"].numpy(), np.asarray(jppo._value(jac, obs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(d["logp"].numpy(), np.asarray(jppo._dist(jac, obs).log_prob(act)),
                               rtol=2e-3, atol=2e-3)


def test_action_is_mean_plus_std_times_box_muller(setup):
    """act = mean + exp(logstd) * eps, with eps recomputed in float64 NumPy
    from the port's Philox uniforms (draws 0..3 the radius, 4..7 the
    angle).  atol 1e-5: float32 log, cos and sqrt against float64."""
    jppo, jac, d = setup["jppo"], setup["jac"], setup["d"]
    mean = np.asarray(jppo._dist(jac, jnp.asarray(d["obs"].numpy())).loc, np.float64)
    env = torch.arange(B)
    eps = []
    for t in range(T):
        u = philox.uniforms(torch.tensor([SEED], dtype=torch.int32), t, env, 8).numpy()
        u = u.astype(np.float64)
        eps.append((np.sqrt(-2.0 * np.log(1.0 - u[:4])) * np.cos(2.0 * np.pi * u[4:])).T)
    want = mean + np.exp(np.asarray(jac.logstd, np.float64)) * np.stack(eps)
    np.testing.assert_allclose(d["act"].numpy(), want, rtol=1e-5, atol=1e-5)


def test_one_step_matches_jax_general_engine(setup):
    """One K3 step from rows with spread control steps (some at the time
    limit) and some envs above the z bound, against the JAX package's
    vec.step_no_reset on the same states and the recorded actions: reward
    rtol 2e-3 (tests/test_fast_policy.py), done and truncation exact, the
    post-step state and the stored terminal obs at the suite's state
    tolerance, and the violation count."""
    fp1 = tp.FastPolicyRollout(setup["tenv"], B, 1, device="cpu")
    rows = setup["rows"].clone()
    max_steps = int(fp1.params["max_steps"])
    rng = np.random.default_rng(2)
    rows[16] = torch.tensor(rng.integers(0, max_steps - 1, B), dtype=torch.float32)
    rows[16, ::8] = max_steps - 1
    rows[4, 4::8] = 2.6  # above z_thr = 2.5: out-of-bound done
    new_rows, traj = fp1.run(rows, setup["weights"], seed=11)
    d = fp1.unpack_traj(traj)

    vec = j_make_vec_env(setup["jenv"], B)
    st, _, _ = jax.jit(vec.reset)(jax.random.key(0))
    off = st.dist_sched["dynamics"]["offsets"]
    st = st.replace(
        x=jnp.asarray(rows[:12].T.numpy()), mass=jnp.asarray(rows[12].numpy()),
        j_diag=jnp.asarray(rows[13:16].T.numpy()),
        ctrl_step=jnp.asarray(rows[16].numpy().astype(np.int32)),
        dist_sched={**st.dist_sched, "dynamics": {
            **st.dist_sched["dynamics"],
            "offsets": jnp.asarray(rows[17].numpy().astype(np.int32)).reshape(off.shape)}})
    jst, jobs, jrew, jdone, jinfo = jax.jit(vec.step_no_reset)(st, jnp.asarray(d["act"][0].numpy()))
    done, trunc = d["done"][0].numpy() > 0, d["trunc"][0].numpy() > 0
    np.testing.assert_allclose(d["rew"][0].numpy(), np.asarray(jrew), rtol=2e-3, atol=1e-6)
    np.testing.assert_array_equal(done, np.asarray(jdone))
    np.testing.assert_array_equal(trunc, np.asarray(jinfo["TimeLimit.truncated"]))
    assert trunc.sum() >= B // 8 - 2 and (done & ~trunc).sum() >= B // 8 - 2
    live = ~done
    np.testing.assert_allclose(new_rows[:12].T.numpy()[live], np.asarray(jst.x)[live],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(d["term_obs"][0].numpy()[trunc], np.asarray(jobs)[trunc],
                               rtol=2e-4, atol=2e-5)
    assert not d["term_obs"][0].numpy()[~trunc].any()
    viol = (new_rows[20] - rows[20]).numpy()[live]
    np.testing.assert_array_equal(viol, np.asarray(jinfo["constraint_violation"])[live])
    # Done envs were reset: fresh episode, step 0, stats folded in.
    assert (new_rows[16].numpy()[done] == 0).all()
    np.testing.assert_array_equal(new_rows[26].numpy(), rows[26].numpy() + done)
    np.testing.assert_array_equal(new_rows[21].numpy(), rows[21].numpy() + done)


def test_plain_matches_constant_action_engine_step(setup):
    """K3's env step is K2's: replaying K3's recorded thrust through
    fast_env.step_rows gives the same rows bit for bit."""
    p, rows0, d = setup["fp"].params, setup["rows0"], setup["d"]
    carry = list(rows0.unbind(0))
    for t in range(T):
        act = list(d["act"][t].T.unbind(0))
        thr = [(1.0 + p["norm_act_scale"] * torch.clamp(a, -1.0, 1.0)) * p["hover_thrust"]
               for a in act]
        carry, rew, done, _, _, _ = tf.step_rows(p, carry, thr, act)
        assert torch.equal(rew, d["rew"][t]) and torch.equal(done.float(), d["done"][t])
    # Bit patterns: the seed row holds int32 seeds, some of them NaN patterns.
    assert torch.equal(torch.stack(carry).view(torch.int32), setup["rows"].view(torch.int32))


def perturbed_policy(jppo, nu, seed=1):
    """The JAX PPO's fresh actor-critic with numpy-seeded noise on the actor
    (its output gain is 0.01) and a logstd that differs per action."""
    jac = jax.device_get(jppo.state.ac)
    rng = np.random.default_rng(seed)
    return jac.replace(
        actor_params=jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                  jac.actor_params),
        logstd=np.linspace(-0.7, -0.3, nu).astype(np.float32))


@pytest.mark.parametrize("hidden", [32, 128])
def test_plain_k3_matches_jax_policy_at_width(setup, hidden):
    """The plain K3 at hidden widths other than 64 (the kernel's run-time
    width instance): recorded v and logp against the JAX package's critic
    and Gaussian actor of that width, weights carried by utils/convert.py."""
    jppo = JPPO(setup["jenv"], seed=0, rollout_batch_size=16, rollout_steps=4, hidden_dim=hidden)
    jac = perturbed_policy(jppo, 4)
    ac = ActorCritic(12, 4, hidden, "tanh")
    convert.load_actor_critic(ac, jac.actor_params, jac.critic_params, jac.logstd)
    fp = tp.FastPolicyRollout(setup["tenv"], 16, 4, mlp_hidden=hidden, device="cpu")
    _, traj = fp.run(fp.reset(seed=0), fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=SEED)
    d = fp.unpack_traj(traj)
    obs, act = jnp.asarray(d["obs"].numpy()), jnp.asarray(d["act"].numpy())
    np.testing.assert_allclose(d["v"].numpy(), np.asarray(jppo._value(jac, obs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(d["logp"].numpy(), np.asarray(jppo._dist(jac, obs).log_prob(act)),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("hidden", [64, 30, 100, 1, 128])
def test_kernel_weights_layout(hidden):
    """The flat vector the policy kernels read (csrc/policy_mlp.cuh): at
    H = 64 the packed tuple transposed and concatenated; at other widths
    each block starts on a multiple of 4 floats, w2^T holds each net's
    columns in a zero-padded block of HP = H rounded up to a multiple of 32,
    and b1 and b2 are zero-padded to a multiple of 4."""
    ac = ActorCritic(12, 4, hidden, "tanh", generator=torch.Generator().manual_seed(0))
    w1, b1, w2, b2, w3, b3, logstd = w = tp.pack_weights(ac.actor, ac.critic, ac.logstd)
    flat = tp.kernel_weights(w)
    H, H2, HP = hidden, 2 * hidden, -(-hidden // 32) * 32
    if hidden == 64:
        want = torch.cat([w1.reshape(-1), b1.reshape(-1), w2.T.reshape(-1), b2.reshape(-1),
                          w3.T.reshape(-1), b3.reshape(-1), logstd])
        assert torch.equal(flat, want)
        return
    up4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    o_b1 = H2 * 12
    o_w2t = o_b1 + up4(H2)
    o_b2 = o_w2t + H2 * 2 * HP
    o_w3t = o_b2 + up4(H2)
    o_b3 = o_w3t + H2 * 8
    assert flat.numel() == o_b3 + 8 + 4
    assert torch.equal(flat[:o_b1].view(H2, 12), w1)
    assert torch.equal(flat[o_b1:o_b1 + H2], b1[:, 0]) and not flat[o_b1 + H2:o_w2t].any()
    w2t = flat[o_w2t:o_b2].view(H2, 2 * HP)
    assert torch.equal(w2t[:, :H], w2.T[:, :H]) and torch.equal(w2t[:, HP:HP + H], w2.T[:, H:])
    assert not w2t[:, H:HP].any() and not w2t[:, HP + H:].any()
    assert torch.equal(flat[o_b2:o_b2 + H2], b2[:, 0]) and not flat[o_b2 + H2:o_w3t].any()
    assert torch.equal(flat[o_w3t:o_b3].view(H2, 8), w3.T)
    assert torch.equal(flat[o_b3:o_b3 + 8], b3[:, 0]) and torch.equal(flat[o_b3 + 8:], logstd)


def test_philox_known_answers():
    """Philox-4x32-10 on the Random123 known-answer vectors."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = philox.philox4x32(*map(t, ctr), t(key[0]), t(key[1]))
        assert [int(w) for w in got] == list(want)


def test_philox_uniform_statistics():
    """4096 envs x 8 draws: all in [0, 1), mean and variance within 4 sigma
    of 1/2 and 1/12; other steps, seeds and draw indices give other words."""
    env = torch.arange(4096)
    u = philox.uniforms(torch.tensor([123], dtype=torch.int32), 5, env, 8).double()
    assert u.dtype == torch.float64 and u.shape == (8, 4096)
    assert (u >= 0).all() and (u < 1).all()
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 4 * np.sqrt(1 / 12 / n)
    assert abs(float(u.var()) - 1 / 12) < 4 * np.sqrt(1 / 180 / n)
    for other in (philox.uniforms(123, 6, env, 8), philox.uniforms(124, 5, env, 8)):
        assert float((other.double() == u).double().mean()) < 0.01
    assert float((u[0] == u[4]).double().mean()) < 0.01


def test_k3_refuses_obs_noise():
    """K3 feeds the observation to the policy and draws a scalar
    observation white noise in-kernel, as K2 admits it; it refuses a masked
    or vector-std one, as the JAX package's does."""
    obs = {"disturbance_func": "white_noise", "std": 0.01}
    noisy = dataclasses.replace(tq.QuadrotorConfig(**CFG), disturbances={
        **CFG["disturbances"], "observation": (obs,)})
    fp = tp.FastPolicyRollout(tq.make_quadrotor(noisy, device="cpu"), 8, 2, device="cpu")
    assert fp.params["obs_noise_std"] == 0.01 and fp.obs_dim == 12
    for spec in ({"mask": [1] * 6 + [0] * 6}, {"std": [0.01] * 12}):
        cfg = dataclasses.replace(noisy, disturbances={
            **CFG["disturbances"], "observation": ({**obs, **spec},)})
        jcfg = jq.QuadrotorConfig(**{**CFG, "disturbances": cfg.disturbances})
        assert not jf.supports(jcfg, allow_normalized=True)
        with pytest.raises(ValueError, match="envelope"):
            tp.FastPolicyRollout(tq.make_quadrotor(cfg, device="cpu"), 8, 2, device="cpu")


def test_supports_normalized_envelope():
    cfg = tq.QuadrotorConfig(**CFG)
    assert tf.supports(cfg, allow_normalized=True) and not tf.supports(cfg)
    noisy = dataclasses.replace(cfg, disturbances={
        **CFG["disturbances"],
        "observation": ({"disturbance_func": "white_noise", "std": 0.01},)})
    assert tf.supports(noisy, allow_normalized=True)
    # Goal-horizon rows: the policy engine takes them (allow_goal_horizon, as
    # the JAX PPO asks, ppo.py:207-210) up to an observation of 128 rows.
    horizon = dataclasses.replace(cfg, obs_goal_horizon=2)
    assert not tf.supports(horizon, allow_normalized=True)
    assert tf.supports(horizon, allow_normalized=True, allow_goal_horizon=True)
    assert tp.FastPolicyRollout(tq.make_quadrotor(horizon, device="cpu"), 8, 2,
                                device="cpu").obs_dim == 36
    above_the_cap = dataclasses.replace(cfg, obs_goal_horizon=10)  # 132 rows
    assert jf.supports(jq.QuadrotorConfig(**{**CFG, "obs_goal_horizon": 10}),
                       allow_normalized=True, allow_goal_horizon=True)
    assert not tf.supports(above_the_cap, allow_normalized=True, allow_goal_horizon=True)
    with pytest.raises(ValueError):
        tp.FastPolicyRollout(tq.make_quadrotor(above_the_cap, device="cpu"), 8, 2, device="cpu")
    with pytest.raises(ValueError):
        tp.FastPolicyRollout(tq.make_quadrotor(cfg, device="cpu"), 8, 2, mlp_act="elu",
                             device="cpu")
    tp.FastPolicyRollout(tq.make_quadrotor(cfg, device="cpu"), 8, 2, mlp_hidden=128, device="cpu")
    with pytest.raises(ValueError):  # the JAX kernels assert hidden <= 128
        tp.FastPolicyRollout(tq.make_quadrotor(cfg, device="cpu"), 8, 2, mlp_hidden=129,
                             device="cpu")


def test_cpu_run_counts_no_launch(setup):
    before = tp.policy_rollout.launches
    setup["fp"].run(setup["rows0"], setup["weights"], seed=1)
    assert tp.policy_rollout.launches == before


@pytest.mark.parametrize("batch", [1024, 1000])
@pytest.mark.parametrize("hidden", [64, 128])
def test_kernel_matches_plain_on_card(setup, hidden, batch):
    """K3 against its plain version on the card, 25 steps through resets:
    rows and record at rtol 2e-4 / atol 2e-5 (the plain version's tanh,
    log and cos are PyTorch's CUDA ops, the kernel's are CUDA's libdevice
    functions), done counts exact; at H = 64 and at the run-time-width
    instance's H = 128, and at a batch (1000) that leaves the last block's
    lane groups partly past the last env."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    env = tq.make_quadrotor(tq.QuadrotorConfig(**{**CFG, "episode_len_sec": 0.2}), device=dev)
    fp = tp.FastPolicyRollout(env, batch, 25, mlp_hidden=hidden, device=dev)
    rows0 = fp.reset(seed=0)
    ac = (setup["ac"] if hidden == 64 else
          ActorCritic(12, 4, hidden, "tanh", generator=torch.Generator().manual_seed(0))).to(dev)
    w = fp.pack_weights(ac.actor, ac.critic, ac.logstd)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    rows, traj = tp.policy_rollout(fp.params, rows0, w, seed)
    rows_p, traj_p = tp.policy_rollout_plain(fp.params, rows0, w, seed)
    torch.cuda.synchronize()
    assert torch.equal(rows[21], rows_p[21]) and rows[21].sum() > 0
    torch.testing.assert_close(rows, rows_p, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(traj, traj_p, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("batch", [1, 33, 1000, 4096])
def test_launch_plan_covers_every_env_once(batch):
    """K3's launch plan stores every env exactly once, from one group inside
    one warp, at H = 64 and 128 and at each group size the kernel's group
    code takes."""
    from tests.test_torch_fast_env import lane_groups

    for hidden in (64, 128):
        for group in (None, 4, 8, 16):
            np.testing.assert_array_equal(lane_groups(tp.launch_plan(batch, hidden, group), batch),
                                          np.arange(batch))


@pytest.mark.parametrize("group", [None, 4, 8, 16, 32])
def test_launch_plan_shared_memory(group):
    """Each group's row of shared memory holds both nets' hidden layers, and
    a block's rows fit the card's 232,448 bytes at every width 1..128; the
    plan raises where the kernel would refuse (a group size other than 4,
    8, 16 or 32, a width past 128)."""
    for hidden in range(1, tp.MAX_HIDDEN + 1):
        G = group or tp.GROUP
        g, block, _, smem = tp.launch_plan(4096, hidden, group)
        assert g == G and smem == block // G * tp.group_row(hidden) * 4 <= 232448
        assert tp.group_row(hidden) >= 4 * hidden and tp.group_row(hidden) % 32 == 4
    for bad in ((4096, 129, group), (4096, 0, group), (4096, 64, 6)):
        with pytest.raises(ValueError):
            tp.launch_plan(*bad)


def test_launch_plan_mirrors_cuda_source():
    """The plan's group size, block and group row are those
    csrc/quad3d_policy_rollout.cu and csrc/lane_group.cuh were built with,
    and the entry point refuses other plans, so the wrapper raises first."""
    import re
    from pathlib import Path

    csrc = Path(tp.__file__).parents[1] / "csrc"
    src = (csrc / "quad3d_policy_rollout.cu").read_text()
    assert int(re.search(r"#define K3_GROUP (\d+)", src).group(1)) == tp.GROUP
    assert int(re.search(r"constexpr int BLOCK = (\d+);", src).group(1)) >= tp.BLOCK
    assert "group != K3_GROUP" in src
    row = re.search(r"mlp_group_row\(int h\) \{ return ([^;]+);",
                    (csrc / "lane_group.cuh").read_text()).group(1)
    for h in range(1, tp.MAX_HIDDEN + 1):
        assert eval(row.replace("/", "//"), {"h": h}) == tp.group_row(h)
