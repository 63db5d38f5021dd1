"""K2 and the whole-rollout engine's host side: the port against the JAX
package (Pallas kernel in interpret mode) and against the port's own
general engine, through auto-resets."""

import re

import jax
import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel import fast_env as tf
from safe_control_gym_torch.parallel import rollout as tro
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import ctr_prng as jp
from safe_control_gym_tpu.parallel import fast_env as jf

B = 128

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
OBS_NOISE = {"observation": ({"disturbance_func": "white_noise", "std": 0.1},)}
_STATE_ROWS = slice(0, 12)
_EXACT_ROWS = [16, 17, 21, 26]  # step, offset, done count, episode index


def _jax_seeds(seed=0):
    keys = jax.random.split(jax.random.key(seed), B)
    return np.asarray(jax.vmap(jp.env_seed_from_key)(keys))


def _envs(**kw):
    cfg = {**CFG4, **kw}
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


def test_supports_envelope():
    ok = tq.QuadrotorConfig(**CFG4)
    assert tf.supports(ok)
    bad = [dict(quad_type=2), dict(cost="competition"), dict(normalized_rl_action_space=True),
           dict(done_on_collision=True),
           dict(disturbances={"observation": ({"disturbance_func": "white_noise", "std": 0.1},
                                              {"disturbance_func": "white_noise", "std": 0.1})}),
           dict(disturbances={"action": ({"disturbance_func": "white_noise", "std": 0.1},)}),
           dict(disturbances={"dynamics": ({"disturbance_func": "uniform"},)}),
           dict(gates=((0.5, -1.0, 0, 0, 0, 0, 0),))]
    for kw in bad:
        assert not tf.supports(tq.QuadrotorConfig(**{**CFG4, **kw})), kw
    # The maze envelope (allow_maze=True) is the JAX package's (the configs
    # of tests/test_torch_maze.py hold the rest of it).
    for kw in [{}] + bad:
        cfg = {**CFG4, **kw}
        assert tf.supports(tq.QuadrotorConfig(**cfg), allow_maze=True) \
            == jf.supports(jq.QuadrotorConfig(**cfg), allow_maze=True), kw
    has, flags = tf.dist_envelope_flags(ok)
    jhas, jflags = jf.dist_envelope_flags(jq.QuadrotorConfig(**CFG4))
    assert (has, flags) == (jhas, jflags)
    # Scalar observation white noise: K2 admits it, as the JAX K2 does, and
    # so does the policy engine (allow_normalized=True), which draws it; a
    # masked one is refused by both packages.
    dist = {**CFG4["disturbances"], **OBS_NOISE}
    noisy = tq.QuadrotorConfig(**{**CFG4, "disturbances": dist})
    assert tf.supports(noisy) and jf.supports(jq.QuadrotorConfig(**{**CFG4, "disturbances": dist}))
    assert tf.supports(noisy, allow_normalized=True)
    masked = {**CFG4, "disturbances": {"observation": ({**OBS_NOISE["observation"][0],
                                                        "mask": [1] * 6 + [0] * 6},)}}
    assert not tf.supports(tq.QuadrotorConfig(**masked), allow_normalized=True)
    assert not jf.supports(jq.QuadrotorConfig(**masked), allow_normalized=True)
    # Goal-horizon rows: the policy engine's (allow_goal_horizon), rl_reward
    # only, as the JAX package's, up to an observation of MAX_OBS = 128 rows
    # (h = 9: 120); the JAX kernel has no cap (h = 10: 132).
    for h, cost, want in ((2, "rl_reward", True), (9, "rl_reward", True),
                          (2, "quadratic", False), (10, "rl_reward", False)):
        cfg = {**CFG4, "obs_goal_horizon": h, "cost": cost, "normalized_rl_action_space": True}
        assert not tf.supports(tq.QuadrotorConfig(**cfg), allow_normalized=True)
        got = tf.supports(tq.QuadrotorConfig(**cfg), allow_normalized=True,
                          allow_goal_horizon=True)
        jax_ok = jf.supports(jq.QuadrotorConfig(**cfg), allow_normalized=True,
                             allow_goal_horizon=True)
        assert got == want and jax_ok == (cost == "rl_reward"), (h, cost)


def test_obs_noise_leaves_k2_rows_unchanged():
    """Config 4 with and without scalar observation white noise: K2 never
    reads the observation, so the plain rows are bit-equal after 25 steps
    through resets."""
    rows = []
    for dist in (CFG4["disturbances"], {**CFG4["disturbances"], **OBS_NOISE}):
        _, tenv = _envs(episode_len_sec=0.2, disturbances=dist)
        fr = tf.FastQuadRollout(tenv, 64, steps_per_call=25, device="cpu")
        rows.append(fr.run(fr.reset(seed=0), np.full(4, float(tenv.u_goal[0]))))
    assert float(rows[0][21].sum()) > 0
    assert torch.equal(rows[0].view(torch.int32), rows[1].view(torch.int32))


def test_engine_params_and_reset_rows_match_jax():
    jenv, tenv = _envs()
    jpar = jf.build_engine_params(jenv, 25, interpret=True)
    tpar = tf.build_engine_params(tenv, 25)
    for k, v in tpar.items():
        if isinstance(v, (tuple, float, int)) and not isinstance(v, str) and v is not None:
            np.testing.assert_array_equal(np.asarray(v, dtype=object if k == "impulse" else None),
                                          np.asarray(jpar[k], dtype=object if k == "impulse" else None),
                                          err_msg=k)
        else:
            assert v == jpar[k], k
    jrows = np.asarray(jf.reset_rows(jpar, B, 1, B, seed=0)).reshape(27, B)
    trows = tf.reset_rows(tpar, torch.tensor(_jax_seeds(0))).numpy()
    # Rows 12-26 bit for bit (the seed row as int32 bit patterns).
    np.testing.assert_array_equal(trows.view(np.int32)[12:], jrows.view(np.int32)[12:])
    np.testing.assert_array_equal(trows[:12], jrows[:12])


def test_plain_kernel_matches_jax_kernel_with_resets():
    """BASELINE config 4 at B=128 for 25 steps from reset: the plain K2
    against the JAX package's K2 (Pallas interpret mode).  Out-of-bound
    auto-resets happen inside the window."""
    jenv, tenv = _envs()
    hover = float(jenv.u_goal[0])
    jfr = jf.FastQuadRollout(jenv, B, steps_per_call=25, sub=1, interpret=True)
    jrows = np.asarray(jfr.run(jfr.reset(seed=0), np.full(4, hover), seed=0)).reshape(27, B)

    tfr = tf.FastQuadRollout(tenv, B, steps_per_call=25, device="cpu")
    before = tf.quad3d_rollout.launches
    trows = tfr.run(tfr.reset(env_seeds=torch.tensor(_jax_seeds(0))), np.full(4, hover)).numpy()
    assert tf.quad3d_rollout.launches == before  # CPU: the plain version

    assert jrows[21].sum() > 0  # resets happened
    np.testing.assert_array_equal(trows[_EXACT_ROWS], jrows[_EXACT_ROWS])
    np.testing.assert_array_equal(trows.view(np.int32)[25], jrows.view(np.int32)[25])
    np.testing.assert_allclose(trows[_STATE_ROWS], jrows[_STATE_ROWS], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(trows[12:16], jrows[12:16], rtol=1e-6)  # inertia
    np.testing.assert_allclose(trows[18:25], jrows[18:25], rtol=2e-4, atol=1e-5)  # stats
    assert tfr.stats(torch.from_numpy(trows))["episodes"] == jrows[21].sum()


def test_plain_kernel_matches_general_engine_with_resets():
    """The port's counterpart of test_fast_env.py::
    test_trajectory_equality_across_engines_with_resets: 6-step episodes,
    several auto-resets in 20 steps, the same env seeds on both engines."""
    cfg = dict(episode_len_sec=0.1, done_on_out_of_bound=False, constraints=None,
               disturbances={"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.02,
                                           "duration": 4, "decay_rate": 0.8},)})
    env = tq.make_quadrotor(tq.QuadrotorConfig(**{**CFG4, **cfg}), device="cpu")
    steps = 20
    seeds = torch.tensor(_jax_seeds(0))
    hover = float(env.u_goal[0])
    fr = tf.FastQuadRollout(env, B, steps_per_call=steps, device="cpu")
    rows0 = fr.reset(env_seeds=seeds)
    vec = make_vec_env(env, B)
    state, obs, _ = vec.reset(env_seeds=seeds)
    torch.testing.assert_close(fr.states(rows0), state.x, rtol=0, atol=0)
    assert torch.equal(fr.pack(state).view(torch.int32), rows0.view(torch.int32))

    rows = fr.run(rows0, np.full(4, hover))
    act = torch.full((B, 4), hover)
    carry = tro.RolloutCarry(state, obs, (), tro.EpisodeStats.create(B))
    carry, _ = tro.rollout(vec, lambda ps, o: (act, ps), carry, steps, collect=False)
    es = carry.env_state
    torch.testing.assert_close(fr.states(rows), es.x, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(rows[12], es.mass, rtol=1e-6, atol=0)
    assert torch.equal(rows[17], es.dist_offsets["dynamics"][:, 0].float())
    assert torch.equal(rows[26], es.episode_idx.float())
    assert torch.equal(rows[21], carry.stats.done_count.float())
    assert torch.equal(rows[16], es.ctrl_step.float())
    torch.testing.assert_close(rows[22], carry.stats.sum_return, rtol=2e-4, atol=1e-5)
    assert float(rows[21].sum()) == 3 * B


def test_pack_and_action_helpers():
    _, tenv = _envs()
    fr = tf.FastQuadRollout(tenv, 8, steps_per_call=3, device="cpu")
    a = fr.prepare_action(np.arange(4, dtype=np.float32))
    assert a.shape == (4, 8) and torch.equal(a[:, 5], torch.arange(4.0))
    per_env = np.arange(32, dtype=np.float32).reshape(8, 4)
    assert torch.equal(fr.prepare_action(per_env), torch.from_numpy(per_env).T)


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    _, tenv = _envs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.FastQuadRollout(tenv, 8)


@pytest.mark.parametrize("batch", [1000, 1])
@pytest.mark.parametrize("config", ["config4", "config5"])
def test_kernel_matches_plain_on_card(config, batch):
    """K2 against its plain version on the card, through resets (chip_smoke.py
    runs the same check at B = 1024 and 1000), at batches that leave the
    last block's lane groups partly past the last env: config 4 for 25
    steps, and config 5 (the maze instance: 4 s episodes, step noise on)
    for 90 steps, all its rows bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from safe_control_gym_torch.baseline import cfg5

    cfg = (tq.QuadrotorConfig(**{**CFG4, "episode_len_sec": 0.2}) if config == "config4"
           else cfg5(episode_len_sec=4))
    env = tq.make_quadrotor(cfg)
    fr = tf.FastQuadRollout(env, batch, steps_per_call=25 if config == "config4" else 90)
    rows0 = fr.reset(seed=0)
    act = fr.prepare_action(np.full(4, float(env.u_goal[0])))
    before = tf.quad3d_rollout.launches
    out = fr.run(rows0, act, seed=3)
    assert tf.quad3d_rollout.launches == before + 1
    ref = tf.quad3d_rollout_plain(fr.params, rows0, act, 3)
    if config == "config5":
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
        assert float(out[21].sum()) > 0
        return
    assert torch.equal(out[_EXACT_ROWS], ref[_EXACT_ROWS]) and float(out[21].sum()) > 0
    assert torch.equal(out.view(torch.int32)[25], rows0.view(torch.int32)[25])
    torch.testing.assert_close(out[:12], ref[:12], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(out[12:16], ref[12:16], rtol=1e-6, atol=0)  # mass, inertia
    torch.testing.assert_close(out[18:25], ref[18:25], rtol=2e-4, atol=1e-5)  # stats


def lane_groups(plan, B):
    """The envs each thread of a launch stores, as ``csrc/lane_group.cuh::
    lane_group`` maps threads: thread t is lane t % G of env t // G, and
    lane 0 of a real env stores it.  Checks that no group straddles a warp."""
    G, block, grid = plan[:3]
    t = np.arange(grid * block)
    lane, env = t % G, t // G
    first = (t % 32) - lane  # warp lane of the group's lane 0
    assert block % 32 == 0 and (first >= 0).all() and (first + G <= 32).all()
    return np.sort(env[(lane == 0) & (env < B)])


@pytest.mark.parametrize("batch", [1, 33, 1000, 4096])
def test_launch_plan_covers_every_env_once(batch):
    """K2's launch plan stores every env exactly once, from one group inside
    one warp, at the default group size and at the others the kernel's
    group code takes."""
    for group in (None, 4, 8, 16):
        np.testing.assert_array_equal(lane_groups(tf.launch_plan(batch, group), batch),
                                      np.arange(batch))
    with pytest.raises(ValueError):
        tf.launch_plan(batch, 6)


def test_launch_plan_mirrors_cuda_source():
    """The plan's group size and block fit what csrc/quad3d_rollout.cu was
    built for (its K2_GROUP and the block its launch bound allows), and its
    entry point refuses other plans, so the wrapper raises first."""
    from pathlib import Path

    src = (Path(tf.__file__).parents[1] / "csrc" / "quad3d_rollout.cu").read_text()
    assert int(re.search(r"#define K2_GROUP (\d+)", src).group(1)) == tf.GROUP
    assert int(re.search(r"constexpr int BLOCK = (\d+);", src).group(1)) >= tf.BLOCK
    assert "group != K2_GROUP" in src


def test_params_struct_mirrors_cuda_source():
    """The ctypes RolloutParams lists the CUDA struct's fields in order, with
    the same types and array lengths (the kernel takes the struct by value,
    so a mismatch would shift every field)."""
    import re
    from pathlib import Path

    csrc = Path(tf.__file__).parents[1] / "csrc"
    src = "".join((csrc / f).read_text() for f in ("quad3d.cuh", "quad3d_rollout.cu"))
    body = re.search(r"struct RolloutParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    want = []
    for ctype, names in re.findall(r"\b(int|float)\s+([^;]+);", body):
        for decl in names.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\d+)\])?\s*", decl)
            want.append((m.group(1), ctype, int(m.group(2) or 1)))
    got = []
    for name, ct in tf.RolloutParams._fields_:
        base = ct._type_ if issubclass(ct, tf.ctypes.Array) else ct
        ctype = "int" if base is tf.ctypes.c_int else "float"
        got.append((name, ctype, getattr(ct, "_length_", 1)))
    assert got == want


def test_wrappers_reject_tensors_off_cpu_and_cuda():
    """Only CPU tensors take the plain versions; anything that is neither
    CPU nor CUDA float32 raises before a kernel is looked up."""
    from safe_control_gym_torch.ops import quad_substeps as K1

    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError):
        K1.quad3d_substeps(m(4, 12), m(4, 4), m(4, 3), m(4), m(4, 3), dt=0.01, n_sub=1)
    _, tenv = _envs()
    p = tf.build_engine_params(tenv, 2)
    with pytest.raises(ValueError):
        tf.quad3d_rollout(p, m(27, 4), m(4, 4))
    with pytest.raises(ValueError):
        tf.quad3d_rollout(p, m(27, 4), m(4, 4), torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        tf.build_engine_params(tq.make_quadrotor(
            tq.QuadrotorConfig(**{**CFG4, "normalized_rl_action_space": True}), device="cpu"), 2)


def test_kernel_build_needs_nvcc():
    import shutil

    from safe_control_gym_torch import kernels

    if shutil.which("nvcc") or (kernels.Path("/usr/local/cuda/bin/nvcc")).exists():
        pytest.skip("nvcc is installed: the build itself runs in chip_smoke.py")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build(force=True)
