#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``safe_control_gym_torch``).

Drives the port's main path, BASELINE config 4 (3D quadrotor, figure-8
tracking, box constraints, impulse disturbance, randomized inertia and
initial state, out-of-bound done, masked auto-reset), on one CUDA card:

1. builds the kernels from ``safe_control_gym_torch/csrc`` and prints the
   card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. holds K1 (``quad3d_substeps``) against its plain PyTorch version at
   B = 4096 on random states, RK4 and Euler;
3. holds K2 (``quad3d_rollout``) against its plain version at B = 1024 for
   25 steps with auto-resets: all rows, done counts exactly;
4. holds K2 against the port's general engine (which runs K1) over the same
   25 steps and env seeds;
5. times the main path at B = 4096: the general engine for 256 hover steps
   and the whole-rollout engine for one call of 8192 steps, after two
   warm-ups, with launch counters zeroed just before and read just after;
   holds each kernel against its plain version on the main path's own
   inputs (K2: all rows after the timed 8192-step call); times each kernel
   alone (profiler device time) and the plain versions (no yardstick of
   speed: they repeat the kernels' arithmetic op by op);
6. holds K3 (``quad3d_policy_rollout``, the PPO data collection) against
   its plain version at B = 1024 for 25 steps through auto-resets: all rows
   and the whole record, done counts exactly;
7. holds K4 (``ppo_grads``, the PPO minibatch gradients) against its plain
   version and against ``torch.autograd`` of the reference losses at
   mb = 131072, H = 64, tanh, and two K4 launches against each other bit
   for bit;
8. drives the training path, PPO on config 4 with the normalized action
   space at the ``rl_train`` shapes (B = 4096, T = 128, 10 epochs of 4
   minibatches of 131072): two warm-up train steps, then 3 timed train
   steps with the launch counters zeroed just before and read just after
   (K3 once and K4 forty times per train step); the device busy share and
   the kernels that take the time; K3 against its plain version on the
   timed call's own input; K3 and K4 timed alone;
9. prints one JSON line of per-kernel results, then the final status line.

Any failure raises and exits non-zero; nothing falls back to the CPU.

    python3 chip_smoke.py [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B_MAIN = 4096
GENERAL_STEPS = 256
FAST_STEPS = 8192
CHECK_B, CHECK_STEPS = 1024, 25
K2_EXACT_ROWS = [16, 17, 21, 26]  # step, offset, done count, episode index
# K2's float rows against the plain version: (what, rows, rtol, atol).  The
# states and statistics take the JAX suite's tolerances; mass and inertia
# (~1e-5 in size) are compared relatively, as the JAX comparison does.
K2_CLOSE_ROWS = (("states", slice(0, 12), 2e-4, 2e-5),
                 ("mass and inertia", slice(12, 16), 1e-6, 0.0),
                 ("statistics", slice(18, 25), 2e-4, 1e-5))

# Data-sheet peaks of an H100 SXM: HBM3 bytes/s
# and float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

# Operation counts by hand from csrc/quad3d.cuh and csrc/quad3d_rollout.cu.
# Each transcendental (sin, cos, exp, sqrt) counts as one operation, which
# keeps the bound a lower bound (an accurate sinf is ~20-40 instructions).
FC_OPS, FC_TRANS = 71, 6  # one rigid-body derivative
RK4_SUBSTEP_OPS = 4 * FC_OPS + 3 * 12 * 2 + 12 * 7  # 4 evals, 3 axpy, combine
ACTUATE_OPS, ACTUATE_TRANS = 10, 1  # per motor
# K2 per env-step beyond the substeps: impulse 8+1, 1/mass, figure-8 goal
# 48+2, violation and bound tests 36, reward 50+1, done 3, statistics 16.
K2_STEP_OPS, K2_STEP_TRANS = 8 + 1 + 48 + 36 + 50 + 3 + 16, 1 + 2 + 1
K2_RESET_OPS = 300  # per auto-reset: 17 counter hashes and affine draws

# The training path (bench.py rl_train): PPO on config 4 with the
# normalized action space, B x T env-steps per train step, EPOCHS epochs of
# N_MINI minibatches of MB samples.
TRAIN_B, TRAIN_T, EPOCHS, HIDDEN = 4096, 128, 10, 64
MB = TRAIN_B * TRAIN_T // 4
N_MINI = TRAIN_B * TRAIN_T // MB
TRAIN_STEPS = 3
# K3 against its plain version: both sides run the same float32 operations
# in the same order (-fmad=false), but tanh, log, cos and exp are CUDA's
# libdevice functions in the kernel and PyTorch's CUDA operators in the
# plain version, which may round differently in the last place.  The record
# and state rows are therefore held at the JAX suite's state tolerance;
# done, truncation and the integer rows exactly.
K3_EXACT_REC = [17, 18]  # done, trunc
K3_RTOL, K3_ATOL = 2e-4, 2e-5
# K4 against its plain version and torch.autograd: sums in other orders
# (the JAX suite's gradient tolerance); loss sums of up to ~1e5 in size
# at rtol 2e-4 with an atol for the one that cancels (sum of logp
# differences).  The actor's hidden-layer gradients are ~1e-5 in size at
# these shapes (a 1/mb factor and an output gain of 0.01), so each
# segment's atol is also held to K4_ATOL_REL times its reference's largest
# entry: float32 sums in other orders stay within ~5e-6 of it (float32
# against float64 on the CPU), and a wrong kernel does not.
K4_RTOL, K4_ATOL, K4_ATOL_REL = 2e-4, 2e-6, 2e-5
K4_SUM_RTOL, K4_SUM_ATOL = 2e-4, 1e-2

# K3 operations per env-step beyond K2's step, the products the function
# needs (csrc/quad3d_policy_rollout.cu skips the zero blocks of the packed
# layout): multiply and add of the actor's and the critic's three layers,
# their biases, and the tanh of their hidden layers; two Philox-4x32-10
# blocks (10 rounds of 2 multiply-highs, 2 multiplies, 3 xors, 2 key adds);
# Box-Muller, log-prob and the normalized action map (4 x (log, sqrt, cos,
# exp) and ~20 operations per action); the four actuations and the action
# cost.
def k3_mlp_ops(h, nx=12, nu=4):
    return 2 * (nx * 2 * h + 2 * h * h + h * (nu + 1)) + 2 * 2 * h + (nu + 1)


K3_MLP_TRANS_PER_H = 4  # tanh of both hidden layers of both nets
K3_RNG_OPS = 2 * 10 * 9
K3_SAMPLE_OPS, K3_SAMPLE_TRANS = 4 * 20, 4 * 4
K3_ACTION_OPS = 4 * (ACTUATE_OPS + ACTUATE_TRANS) + 16
# K4 operations per sample, counted from csrc/ppo_update.cu as written:
# forward of both nets (multiply-add of three layers, biases, tanh), the
# backward into both hidden layers (tanh' = 1 - a^2), and one multiply-add
# per sample into every weight gradient entry (an add for each bias entry),
# plus the losses (exp of the ratio, 4 exp of logstd, ~60 operations).
def k4_ops_per_sample(nx, nu, h):
    fwd = 2 * (2 * (nx * h + h * h) + (nu + 1) * h) + 2 * h * 2 + (nu + 1) + 2 * 2 * h
    bwd = 2 * (nu + 1) * h + 2 * (2 * h * h) + 2 * 2 * h * 3
    acc = 2 * (2 * (nx * h + h * h) + (nu + 1) * h) + (4 * h + nu + 1 + nu + 3)
    return fwd + bwd + acc + 2 + 4 + 60


def cfg4(**kw):
    """BASELINE config 4 (bench.py build())."""
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig

    base = dict(
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
    base.update(kw)
    return QuadrotorConfig(**base)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_kernels(fn, reps):
    """Run ``fn`` ``reps`` times under torch.profiler; return (wall ms,
    {kernel name: (device ms total, launches)}) for the CUDA kernels seen."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
    return wall, kern


def kernel_device_ms(fn, name, reps):
    """Mean device time per launch of the kernel whose name holds ``name``;
    raises where the profiler records no device time for it."""
    _, kern = profile_kernels(fn, reps)
    hits = [(t, n) for k, (t, n) in kern.items() if name in k]
    if not hits:
        raise RuntimeError(f"the profiler recorded no device time for {name}; "
                           f"kernels seen: {sorted(kern)}")
    return sum(t for t, _ in hits) / sum(n for _, n in hits)


def check(name, ok, detail):
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        raise AssertionError(f"{name} failed: {detail}")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def check_k2_rows(tag, out, ref, rows_in):
    """All 27 state rows a kernel (K2 or K3) left against its plain
    version's on the same input rows; returns the largest absolute
    difference on the float rows."""
    import torch

    diff = (out[K2_EXACT_ROWS] != ref[K2_EXACT_ROWS]).any(0)
    done_k, done_p = int(out[21].sum()), int(ref[21].sum())
    check(f"{tag}: step, offset, done and episode rows", not bool(diff.any()) and done_k > 0,
          f"episodes {done_k} vs {done_p}; {int(diff.sum())} envs differ (exact)")
    seed = rows_in[25].view(torch.int32)
    check(f"{tag}: seed row bits", torch.equal(out[25].view(torch.int32), seed)
          and torch.equal(ref[25].view(torch.int32), seed), "copied through unchanged")
    errs = []
    for what, rs, rtol, atol in K2_CLOSE_ROWS:
        err = max_err(out[rs], ref[rs])
        errs.append(err)
        check(f"{tag}: {what}", bool(torch.isclose(out[rs], ref[rs], rtol=rtol, atol=atol).all()),
              f"max_abs_err {err:.3g} (rtol {rtol:g}, atol {atol:g})")
    return max(errs)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def phase_build():
    import torch

    from safe_control_gym_torch import kernels

    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    build_s = time.perf_counter() - t0
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"[ok] build: {build_s:.1f} s")
    log = (kernels.BUILD / "ptxas.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas:", line.strip())
    return build_s


def phase_k1(dev):
    import torch

    from safe_control_gym_torch.ops import quad_substeps as K1

    rng = np.random.default_rng(0)
    B = B_MAIN
    x = torch.tensor(rng.standard_normal((B, 12)) * 0.2, dtype=torch.float32, device=dev)
    thr = torch.tensor(rng.uniform(0.0, 0.16, (B, 4)), dtype=torch.float32, device=dev)
    ext = torch.tensor(rng.standard_normal((B, 3)) * 1e-3, dtype=torch.float32, device=dev)
    m = torch.full((B,), 0.027, device=dev)
    j = torch.tensor([1.4e-5, 1.4e-5, 2.17e-5], device=dev).repeat(B, 1)
    errs = {}
    for euler in (False, True):
        kw = dict(dt=1 / 240, n_sub=4, euler=euler, actuation=True)
        out = K1.quad3d_substeps(x, thr, ext, m, j, **kw)
        ref = K1.quad3d_substeps_plain(x, thr, ext, m, j, **kw)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        rel = float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max())
        errs["euler" if euler else "rk4"] = err
        check(f"K1 {'euler' if euler else 'rk4'} vs plain (B={B})",
              bool(torch.isfinite(out).all()) and rel <= 2e-6,
              f"max_abs_err {err:.3g}, max err/max(1,|ref|) {rel:.3g} (tolerance 2e-6)")
    return errs, (x, thr, ext, m, j)


def phase_k2(dev):
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_env as F

    env = make_quadrotor(cfg4(episode_len_sec=0.2), device=dev)
    fr = F.FastQuadRollout(env, CHECK_B, steps_per_call=CHECK_STEPS, device=dev)
    rows0 = fr.reset(seed=0)
    act = fr.prepare_action(np.full(4, float(env.u_goal[0])))
    out = fr.run(rows0, act)
    ref = F.quad3d_rollout_plain(fr.params, rows0, act)
    torch.cuda.synchronize()
    err = check_k2_rows(f"K2 vs plain (B={CHECK_B}, {CHECK_STEPS} steps)", out, ref, rows0)
    return err, env, fr, rows0, out


def phase_cross(dev, env, fr, rows0, rows_k2):
    import torch

    from safe_control_gym_torch.parallel import rollout as R
    from safe_control_gym_torch.parallel.vector import make_vec_env

    vec = make_vec_env(env, CHECK_B)
    state, obs, _ = vec.reset(seed=0)
    check("reset rows vs general-engine reset",
          torch.equal(fr.pack(state).view(torch.int32), rows0.view(torch.int32)),
          "bit-identical packed state")
    hover = torch.full((CHECK_B, 4), float(env.u_goal[0]), device=dev)
    carry = R.RolloutCarry(state, obs, (), R.EpisodeStats.create(CHECK_B, device=dev))
    carry, _ = R.rollout(vec, lambda ps, o: (hover, ps), carry, CHECK_STEPS, collect=False)
    es = carry.env_state
    torch.cuda.synchronize()
    done_same = torch.equal(rows_k2[21], carry.stats.done_count.float())
    check("K2 vs general engine: done counts", done_same,
          f"{int(rows_k2[21].sum())} vs {int(carry.stats.done_count.sum())} episodes")
    same = (torch.equal(rows_k2[26], es.episode_idx.float())
            and torch.equal(rows_k2[16], es.ctrl_step.float())
            and torch.equal(rows_k2[17], es.dist_offsets["dynamics"][:, 0].float()))
    check("K2 vs general engine: episode, step and offset rows", same, "exact")
    err = max_err(rows_k2[:12].T, es.x)
    close = bool(torch.isclose(rows_k2[:12].T, es.x, rtol=2e-4, atol=2e-5).all())
    check("K2 vs general engine: states", close, f"max_abs_err {err:.3g} (rtol 2e-4, atol 2e-5)")
    return err


def phase_main(dev):
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.ops import quad_substeps as K1
    from safe_control_gym_torch.parallel import fast_env as F
    from safe_control_gym_torch.parallel import rollout as R
    from safe_control_gym_torch.parallel.vector import make_vec_env

    env = make_quadrotor(cfg4(), device=dev)
    hover_f = float(env.u_goal[0])
    res = {}

    # -- general engine: make_vec_env + rollout, K1 once per step.
    vec = make_vec_env(env, B_MAIN)
    hover = torch.full((B_MAIN, 4), hover_f, device=dev)
    policy = lambda ps, o: (hover, ps)  # noqa: E731

    state, obs, _ = vec.reset(seed=0)
    carry0 = R.RolloutCarry(state, obs, (), R.EpisodeStats.create(B_MAIN, device=dev))

    def general():
        return R.rollout(vec, policy, carry0, GENERAL_STEPS, collect=False)[0]

    general()
    general()
    torch.cuda.synchronize()
    K1.quad3d_substeps.launches = 0
    F.quad3d_rollout.launches = 0
    t0 = time.perf_counter()
    carry = general()
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    res["k1_launches"] = K1.quad3d_substeps.launches
    res["general_k2_launches"] = F.quad3d_rollout.launches
    check("general engine output", bool(torch.isfinite(carry.env_state.x).all())
          and tuple(carry.env_state.x.shape) == (B_MAIN, 12),
          f"finite (B, 12) states; {carry.stats.means()}")
    res["general_env_steps_s"] = B_MAIN * GENERAL_STEPS / t_gen
    res["general_s"] = t_gen

    # -- whole-rollout engine: one launch of FAST_STEPS steps.
    fr = F.FastQuadRollout(env, B_MAIN, steps_per_call=FAST_STEPS, device=dev)
    act = fr.prepare_action(np.full(4, hover_f))
    rows_in = fr.run(fr.reset(seed=0), act)
    rows_in = fr.run(rows_in, act)
    torch.cuda.synchronize()
    K1.quad3d_substeps.launches = 0
    F.quad3d_rollout.launches = 0
    t0 = time.perf_counter()
    rows = fr.run(rows_in, act)
    torch.cuda.synchronize()
    t_fast = time.perf_counter() - t0
    res["k2_launches"] = F.quad3d_rollout.launches
    res["fast_k1_launches"] = K1.quad3d_substeps.launches
    res["fast_env_steps_s"] = B_MAIN * FAST_STEPS / t_fast
    res["fast_call_ms"] = t_fast * 1e3
    res["fast_resets"] = float(rows[21].sum() - rows_in[21].sum())
    body = torch.cat([rows[:25], rows[26:]])
    check("whole-rollout output", bool(torch.isfinite(body).all()),
          f"finite rows; {fr.stats(rows)}")
    check("main path went through the kernels",
          res["k1_launches"] == GENERAL_STEPS and res["k2_launches"] == 1,
          f"K1 launches {res['k1_launches']} in {GENERAL_STEPS} general steps, "
          f"K2 launches {res['k2_launches']} in one whole-rollout call")

    # -- the plain K2 on the timed call's own rows and action: K2's check at
    # the main path's shapes, and the plain version's time.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rows_plain = F.quad3d_rollout_plain(fr.params, rows_in, act)
    end.record()
    torch.cuda.synchronize()
    res["k2_plain_ms"] = start.elapsed_time(end)
    res["k2_main_max_abs_err"] = check_k2_rows(
        f"K2 vs plain on the main path (B={B_MAIN}, {FAST_STEPS} steps)", rows, rows_plain, rows_in)

    # -- where the general engine's time goes: device busy share and the
    # kernels that take it, over 32 steps.
    short = lambda: R.rollout(vec, policy, carry0, 32, collect=False)  # noqa: E731
    _, kern = profile_kernels(short, 1)
    busy = sum(t for t, _ in kern.values())
    t0 = time.perf_counter()
    short()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3  # without the profiler's overhead
    res["general_profile"] = {
        "wall_ms": wall, "device_ms": busy, "busy_share": busy / wall if wall else None,
        "kernel_launches": sum(n for _, n in kern.values()),
        "top": sorted(((k[:80], t, n) for k, (t, n) in kern.items()),
                      key=lambda r: -r[1])[:6]}

    # -- K1 at the general engine's inputs (reset states, hover, no
    # impulse): against its plain version, then timed alone.  ``ms`` is the
    # profiler's device time; the CUDA-event time of back-to-back launches
    # from Python (host launch overhead included) is kept beside it.
    state, _, _ = vec.reset(seed=0)
    ext = torch.zeros((B_MAIN, 3), device=dev)
    k1_args = (state.x, hover, ext, state.mass, state.j_diag)
    k1_kw = dict(dt=1 / 240, n_sub=4, euler=False, actuation=True)
    fn = lambda: K1.quad3d_substeps(*k1_args, **k1_kw)  # noqa: E731
    out, ref = fn(), K1.quad3d_substeps_plain(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    res["k1_main_max_abs_err"] = max_err(out, ref)
    rel = float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max())
    check(f"K1 vs plain on the general engine's inputs (B={B_MAIN})", rel <= 2e-6,
          f"max_abs_err {res['k1_main_max_abs_err']:.3g}, max err/max(1,|ref|) {rel:.3g} "
          "(tolerance 2e-6)")
    cuda_ms(fn, 50)
    res["k1_launch_ms"] = cuda_ms(fn, 2000)
    res["k1_ms"] = kernel_device_ms(fn, "quad3d_substeps_kernel", 200)
    res["k1_plain_ms"] = cuda_ms(lambda: K1.quad3d_substeps_plain(*k1_args, **k1_kw), 20)
    res["k2_ms"] = kernel_device_ms(lambda: F.quad3d_rollout(fr.params, rows_in, act),
                                    "quad3d_rollout_kernel", 2)
    return res


def seeded_ac(dev, seed=0):
    """Actor-critic of the rl_train widths with weights from a fixed seed."""
    import torch

    from safe_control_gym_torch.controllers.ppo import ActorCritic

    ac = ActorCritic(12, 4, HIDDEN, "tanh", generator=torch.Generator().manual_seed(seed))
    return ac.to(dev)


def check_k3(tag, rows, traj, rows_p, traj_p, rows_in):
    """K3's rows and record against its plain version's on the same
    inputs; returns (largest absolute difference, share of record entries
    that differ at all)."""
    import torch

    err_rows = check_k2_rows(f"K3 {tag}", rows, rows_p, rows_in)
    exact = torch.equal(traj[:, K3_EXACT_REC], traj_p[:, K3_EXACT_REC])
    check(f"K3 {tag}: done and truncation records", exact,
          f"{int(traj[:, 17].sum())} vs {int(traj_p[:, 17].sum())} dones, exact")
    err = max_err(traj, traj_p)
    close = bool(torch.isclose(traj, traj_p, rtol=K3_RTOL, atol=K3_ATOL).all())
    differ = float((traj != traj_p).double().mean())
    check(f"K3 {tag}: whole record", close and bool(torch.isfinite(traj).all()),
          f"max_abs_err {err:.3g}, {differ:.3g} of entries not bit-equal "
          f"(rtol {K3_RTOL:g}, atol {K3_ATOL:g})")
    return max(err, err_rows), differ


def phase_k3(dev):
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_policy as P

    env = make_quadrotor(cfg4(episode_len_sec=0.2, normalized_rl_action_space=True), device=dev)
    fp = P.FastPolicyRollout(env, CHECK_B, CHECK_STEPS, mlp_hidden=HIDDEN, device=dev)
    rows0 = fp.reset(seed=0)
    ac = seeded_ac(dev)
    w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    rows, traj = P.policy_rollout(fp.params, rows0, w, seed)
    rows_p, traj_p = P.policy_rollout_plain(fp.params, rows0, w, seed)
    torch.cuda.synchronize()
    return check_k3(f"vs plain (B={CHECK_B}, {CHECK_STEPS} steps)", rows, traj, rows_p, traj_p,
                    rows0)


def k4_inputs(dev, ac, n, seed=0):
    """A seeded (20, n) minibatch near the policy ``ac``: ratios spread
    over both sides of the clip range."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    with torch.no_grad():
        obs = 0.5 * rn(n, 12)
        mean, std = ac.actor(obs), torch.exp(ac.logstd)
        act = mean + std * rn(n, 4)
        logp = (-((act - mean) ** 2) / (2 * std**2) - torch.log(std)
                - 0.5 * float(np.log(2 * np.pi))).sum(-1)
        v = ac.critic(obs)[:, 0]
        cols = [obs, act, v[:, None], (logp + 0.3 * rn(n))[:, None],
                (v + rn(n))[:, None], rn(n)[:, None]]
    return torch.cat(cols, 1).T.contiguous()


def k4_autograd(ac, mb, clip):
    """torch.autograd of the reference losses (the minibatch's mean clipped
    surrogate and half its mean squared value error): the gradients K4
    returns, keyed like fast_update.SEGMENTS, and the 3 loss sums."""
    import torch

    from safe_control_gym_torch.parallel import fast_update as U

    obs, act, logp_old, ret, adv = mb[:12].T, mb[12:16].T, mb[17], mb[18], mb[19]
    params = dict(zip(U.SEGMENTS, [p for net in (ac.actor, ac.critic) for p in net.parameters()]
                      + [ac.logstd]))
    with torch.enable_grad():
        mean, std = ac.actor(obs), torch.exp(ac.logstd)
        logp = (-((act - mean) ** 2) / (2 * std**2) - ac.logstd
                - 0.5 * float(np.log(2 * np.pi))).sum(-1)
        ratio = torch.exp(logp - logp_old)
        min_surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        v = ac.critic(obs)[:, 0]
        loss = -min_surr.mean() + 0.5 * ((v - ret) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
    sums = torch.stack([min_surr.sum(), (logp_old - logp).sum(), ((v - ret) ** 2).sum()])
    return dict(zip(params, grads)), sums.detach()


def check_grads(tag, g, sums, g_ref, sums_ref):
    import torch

    from safe_control_gym_torch.parallel import fast_update as U

    errs = []
    for k in U.SEGMENTS:
        ref = g_ref[k].reshape(g[k].shape)
        scale = float(ref.abs().max())
        atol = min(K4_ATOL, K4_ATOL_REL * scale)
        errs.append(max_err(g[k], ref))
        check(f"K4 {tag}: {k}", bool(torch.isclose(g[k], ref, rtol=K4_RTOL, atol=atol).all()),
              f"max_abs_err {errs[-1]:.3g} against max|ref| {scale:.3g} "
              f"(rtol {K4_RTOL:g}, atol {atol:.3g})")
    ok = bool(torch.isclose(sums, sums_ref, rtol=K4_SUM_RTOL, atol=K4_SUM_ATOL).all())
    check(f"K4 {tag}: loss sums", ok, f"{sums.tolist()} vs {sums_ref.tolist()} "
          f"(rtol {K4_SUM_RTOL:g}, atol {K4_SUM_ATOL:g})")
    return max(errs)


def phase_k4(dev):
    """K4 at the main path's shapes on a seeded minibatch."""
    import torch

    from safe_control_gym_torch.parallel import fast_update as U

    ac = seeded_ac(dev, seed=1)
    with torch.no_grad():  # spread logstd so each action dim differs
        ac.logstd.copy_(torch.tensor([-0.5, -0.7, -0.3, -0.6], device=dev))
    mb = k4_inputs(dev, ac, MB)
    w = U.prep_weights(ac.actor, ac.critic, ac.logstd)
    g1, s1 = U.ppo_grads(mb, w, clip=0.2)
    g2, s2 = U.ppo_grads(mb, w, clip=0.2)
    gp, sp = U.ppo_grads_plain(mb, w, clip=0.2)
    ga, sa = k4_autograd(ac, mb, 0.2)
    torch.cuda.synchronize()
    same = all(torch.equal(g1[k], g2[k]) for k in U.SEGMENTS) and torch.equal(s1, s2)
    check(f"K4 two launches on the same input (mb={MB})", same, "bit-equal")
    err = check_grads(f"vs plain (mb={MB})", g1, s1, gp, sp)
    err_ag = check_grads(f"vs torch.autograd (mb={MB})", g1, s1, ga, sa)
    return err, err_ag


def phase_train(dev):
    """The training path: PPO train steps at the rl_train shapes."""
    import torch

    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.ops import quad_substeps as K1
    from safe_control_gym_torch.parallel import fast_env as F
    from safe_control_gym_torch.parallel import fast_policy as P
    from safe_control_gym_torch.parallel import fast_update as U

    env = make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev)
    ppo = PPO(env, seed=0, rollout_batch_size=TRAIN_B, rollout_steps=TRAIN_T, opt_epochs=EPOCHS,
              mini_batch_size=MB, hidden_dim=HIDDEN, use_fast_rollout=True,
              reshuffle_each_epoch=False)
    check("PPO on the card takes K3 and K4", ppo._fp is not None and ppo._fu is not None,
          "use_fast_rollout=True, use_fast_update='auto' on CUDA")
    res = {}
    for _ in range(2):
        ppo.state, _ = ppo._train_step(ppo.state)
    # The first timed call's own K3 input: rows, packed weights, and the
    # seed the controller's generator is about to draw.
    fp, ac = ppo._fp, ppo.state.ac
    rows_in = ppo.state.env_state.clone()
    w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
    gen = torch.Generator(device=dev)
    gen.set_state(ppo.gen.get_state())
    seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    for c in (K1.quad3d_substeps, F.quad3d_rollout, P.policy_rollout, U.ppo_grads):
        c.launches = 0
    t0 = time.perf_counter()
    ppo.state, metrics = ppo.train_many(TRAIN_STEPS)(ppo.state)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    res["k3_launches"] = P.policy_rollout.launches
    res["k4_launches"] = U.ppo_grads.launches
    res["train_k1_k2_launches"] = K1.quad3d_substeps.launches + F.quad3d_rollout.launches
    res["train_step_s"] = t_train / TRAIN_STEPS
    res["train_env_steps_s"] = TRAIN_STEPS * TRAIN_B * TRAIN_T / t_train
    res["train_metrics"] = {k: float(v) for k, v in metrics.items()}
    check("train steps went through the kernels",
          res["k3_launches"] == TRAIN_STEPS and res["k4_launches"] == TRAIN_STEPS * EPOCHS * N_MINI,
          f"K3 {res['k3_launches']} and K4 {res['k4_launches']} launches in {TRAIN_STEPS} train "
          f"steps (want 1 and {EPOCHS * N_MINI} per step)")
    check("train step output", all(np.isfinite(v) for v in res["train_metrics"].values())
          and ppo.state.total_steps == (2 + TRAIN_STEPS) * TRAIN_B * TRAIN_T,
          f"finite metrics {res['train_metrics']}, total_steps {ppo.state.total_steps}")

    # -- K3 against its plain version on the first timed call's own input.
    rows, traj = P.policy_rollout(fp.params, rows_in, w, seed)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rows_p, traj_p = P.policy_rollout_plain(fp.params, rows_in, w, seed)
    end.record()
    torch.cuda.synchronize()
    res["k3_plain_ms"] = start.elapsed_time(end)
    res["k3_main_max_abs_err"], res["k3_main_differ"] = check_k3(
        f"vs plain on the training path (B={TRAIN_B}, {TRAIN_T} steps)", rows, traj, rows_p,
        traj_p, rows_in)
    res["k3_resets"] = float(rows[21].sum() - rows_in[21].sum())

    # -- where a train step's time goes: device busy share and the kernels.
    step = lambda: ppo._train_step(ppo.state)  # noqa: E731
    _, kern = profile_kernels(step, 1)
    busy = sum(t for t, _ in kern.values())
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    k3_dev = sum(t for k, (t, _) in kern.items() if "quad3d_policy_rollout" in k)
    k4_dev = sum(t for k, (t, _) in kern.items() if "ppo_grads" in k)
    res["train_profile"] = {
        "wall_ms": wall, "device_ms": busy, "busy_share": busy / wall if wall else None,
        "k3_device_ms": k3_dev, "k4_device_ms": k4_dev,
        "kernel_launches": sum(n for _, n in kern.values()),
        "top": sorted(((k[:80], t, n) for k, (t, n) in kern.items()), key=lambda r: -r[1])[:10]}

    # -- K3 and K4 alone (profiler device time), and K4's plain version.
    res["k3_ms"] = kernel_device_ms(lambda: P.policy_rollout(fp.params, rows_in, w, seed),
                                    "quad3d_policy_rollout_kernel", 3)
    mb = k4_inputs(dev, ac, MB, seed=2)
    wk = U.prep_weights(ac.actor, ac.critic, ac.logstd)
    _, kern = profile_kernels(lambda: U.ppo_grads(mb, wk, clip=0.2), 20)
    res["k4_ms"] = sum(t for k, (t, _) in kern.items() if "ppo_grads" in k) / 20
    plain = lambda: U.ppo_grads_plain(mb, wk, clip=0.2)  # noqa: E731
    cuda_ms(plain, 3)
    res["k4_plain_ms"] = cuda_ms(plain, 20)
    return res


def bounds(res):
    """Least time the card could take for each kernel's main-path work."""
    B = B_MAIN
    k1_bytes = B * (12 + 4 + 3 + 1 + 3 + 12) * 4
    k1_ops = B * (4 * RK4_SUBSTEP_OPS + 4 * ACTUATE_OPS + 1
                  + 4 * 4 * FC_TRANS + 4 * ACTUATE_TRANS)
    k2_bytes = B * (2 * 27 + 4) * 4
    env_steps = B * FAST_STEPS
    k2_ops = (env_steps * (4 * RK4_SUBSTEP_OPS + 4 * 4 * FC_TRANS + K2_STEP_OPS + K2_STEP_TRANS)
              + res["fast_resets"] * K2_RESET_OPS + B * 4 * (ACTUATE_OPS + ACTUATE_TRANS))
    # K3 at the training path's shapes: rows in and out, the packed weights
    # read once, the record written once; K2's step plus the policy per
    # env-step, the resets this run's timed call made.
    h2 = 2 * HIDDEN
    n_w = h2 * 12 + h2 + h2 * h2 + h2 + 8 * h2 + 8 + 4
    k3_bytes = 4 * (TRAIN_B * 2 * 27 + n_w + TRAIN_T * 33 * TRAIN_B)
    k3_steps = TRAIN_B * TRAIN_T
    k3_ops = (k3_steps * (4 * RK4_SUBSTEP_OPS + 4 * 4 * FC_TRANS + K2_STEP_OPS + K2_STEP_TRANS
                          + k3_mlp_ops(HIDDEN) + K3_MLP_TRANS_PER_H * HIDDEN + K3_RNG_OPS
                          + K3_SAMPLE_OPS + K3_SAMPLE_TRANS + K3_ACTION_OPS)
              + res["k3_resets"] * K2_RESET_OPS)
    # K4 per launch: the minibatch read once, the weights read and the
    # gradients and loss sums written once.
    n_g = 2 * (HIDDEN * 12 + HIDDEN + HIDDEN * HIDDEN + HIDDEN) + 4 * HIDDEN + 4 + HIDDEN + 1 + 4
    k4_bytes = 4 * (20 * MB + 2 * n_g + 3)
    k4_ops = MB * k4_ops_per_sample(12, 4, HIDDEN)
    out = {}
    for name, nbytes, ops in (("k1", k1_bytes, k1_ops), ("k2", k2_bytes, k2_ops),
                              ("k3", k3_bytes, k3_ops), ("k4", k4_bytes, k4_ops)):
        t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
        out[name] = {"bytes": nbytes, "ops": ops, "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations"}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    build_s = phase_build()
    k1_errs, _ = phase_k1(dev)
    k2_err, env_c, fr_c, rows0, rows_k2 = phase_k2(dev)
    cross_err = phase_cross(dev, env_c, fr_c, rows0, rows_k2)
    res = phase_main(dev)
    k3_err, k3_differ = phase_k3(dev)
    k4_err, k4_err_ag = phase_k4(dev)
    res.update(phase_train(dev))
    bnd = bounds(res)

    from safe_control_gym_torch.ops import quad_substeps as K1
    from safe_control_gym_torch.parallel import fast_env as F

    print(f"general engine: {res['general_env_steps_s']:.6g} env-steps/s "
          f"(B={B_MAIN}, {GENERAL_STEPS} steps in {res['general_s']:.4f} s)")
    print(f"whole-rollout engine: {res['fast_env_steps_s']:.6g} env-steps/s "
          f"(B={B_MAIN}, {FAST_STEPS} steps in {res['fast_call_ms']:.4f} ms)")
    print(f"K1 device time {res['k1_ms'] * 1e3:.4f} us per launch at block {K1.BLOCK} "
          f"(bound {bnd['k1']['bound_ms'] * 1e3:.4f} us); back-to-back from Python "
          f"{res['k1_launch_ms'] * 1e3:.4f} us per launch")
    print(f"K2 device time {res['k2_ms']:.4f} ms per call of {FAST_STEPS} steps at block "
          f"{F.BLOCK} (bound {bnd['k2']['bound_ms']:.4f} ms); "
          f"{res['fast_resets']:.0f} auto-resets per call")
    gp = res["general_profile"]
    print(f"general engine, 32 steps: wall {gp['wall_ms']:.3f} ms, device busy "
          f"{gp['device_ms']:.3f} ms ({gp['busy_share']}), {gp['kernel_launches']} "
          f"kernel launches; top {gp['top']}")
    print(f"launch counters: K1 {res['k1_launches']}, K2 {res['k2_launches']}")
    print(f"plain versions (no yardstick): K1 {res['k1_plain_ms']:.4f} ms per call, "
          f"K2 {res['k2_plain_ms']:.1f} ms per call of {FAST_STEPS} steps")
    tp = res["train_profile"]
    print(f"PPO train step (B={TRAIN_B}, T={TRAIN_T}, {EPOCHS} epochs x {N_MINI} minibatches of "
          f"{MB}): {res['train_env_steps_s']:.6g} env-steps/s, {res['train_step_s'] * 1e3:.3f} ms "
          f"per train step over {TRAIN_STEPS}; metrics {res['train_metrics']}")
    print(f"launches per train step: K3 {res['k3_launches'] / TRAIN_STEPS:g}, "
          f"K4 {res['k4_launches'] / TRAIN_STEPS:g}; K1+K2 {res['train_k1_k2_launches']}")
    print(f"train step: wall {tp['wall_ms']:.3f} ms, device busy {tp['device_ms']:.3f} ms "
          f"({tp['busy_share']}), K3 {tp['k3_device_ms']:.3f} ms, K4 {tp['k4_device_ms']:.3f} ms, "
          f"{tp['kernel_launches']} kernel launches; top {tp['top']}")
    print(f"K3 device time {res['k3_ms']:.4f} ms per call of {TRAIN_T} steps "
          f"(bound {bnd['k3']['bound_ms']:.4f} ms, {bnd['k3']['bound_by']}); "
          f"plain {res['k3_plain_ms']:.1f} ms; {res['k3_resets']:.0f} auto-resets")
    print(f"K4 device time {res['k4_ms'] * 1e3:.2f} us per launch at mb={MB} "
          f"(bound {bnd['k4']['bound_ms'] * 1e3:.2f} us, {bnd['k4']['bound_by']}); "
          f"plain {res['k4_plain_ms'] * 1e3:.2f} us")

    kernels_line = {"kernels": [
        {"name": "quad3d_substeps", "route": "cuda",
         "source": "safe_control_gym_torch/csrc/quad3d_substeps.cu",
         "replaces": "safe_control_gym_tpu/ops/pallas_quad.py:109",
         "launches": res["k1_launches"],
         "max_abs_err": max(*k1_errs.values(), res["k1_main_max_abs_err"]),
         "ms": res["k1_ms"], "plain_ms": res["k1_plain_ms"],
         "bound_ms": bnd["k1"]["bound_ms"], "bound_by": bnd["k1"]["bound_by"],
         "library_ms": None, "block": K1.BLOCK},
        {"name": "quad3d_rollout", "route": "cuda",
         "source": "safe_control_gym_torch/csrc/quad3d_rollout.cu",
         "replaces": "safe_control_gym_tpu/parallel/fast_env.py:593",
         "launches": res["k2_launches"],
         "max_abs_err": max(k2_err, res["k2_main_max_abs_err"]),
         "max_abs_err_vs_general_engine": cross_err,
         "ms": res["k2_ms"], "plain_ms": res["k2_plain_ms"],
         "bound_ms": bnd["k2"]["bound_ms"], "bound_by": bnd["k2"]["bound_by"],
         "library_ms": None, "block": F.BLOCK},
        {"name": "quad3d_policy_rollout", "route": "cuda",
         "source": "safe_control_gym_torch/csrc/quad3d_policy_rollout.cu",
         "replaces": "safe_control_gym_tpu/parallel/fast_policy.py:76",
         "launches": res["k3_launches"],
         "max_abs_err": max(k3_err, res["k3_main_max_abs_err"]),
         "share_not_bit_equal": max(k3_differ, res["k3_main_differ"]),
         "ms": res["k3_ms"], "plain_ms": res["k3_plain_ms"],
         "bound_ms": bnd["k3"]["bound_ms"], "bound_by": bnd["k3"]["bound_by"],
         "library_ms": None},
        {"name": "ppo_grads", "route": "cuda",
         "source": "safe_control_gym_torch/csrc/ppo_update.cu",
         "replaces": "safe_control_gym_tpu/parallel/fast_update.py:44",
         "launches": res["k4_launches"],
         "max_abs_err": k4_err, "max_abs_err_vs_autograd": k4_err_ag,
         "ms": res["k4_ms"], "plain_ms": res["k4_plain_ms"],
         "bound_ms": bnd["k4"]["bound_ms"], "bound_by": bnd["k4"]["bound_by"],
         "library_ms": None},
    ]}
    total_s = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s, "total_s": total_s,
                       "k1_max_abs_err": k1_errs, "k2_vs_plain_max_abs_err": k2_err,
                       "k2_vs_general_max_abs_err": cross_err, "bounds": bnd,
                       "k3_vs_plain_max_abs_err": k3_err, "k4_vs_plain_max_abs_err": k4_err,
                       "k4_vs_autograd_max_abs_err": k4_err_ag,
                       **res, **kernels_line}, f, indent=1, default=str)
    print(f"total {total_s:.1f} s")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
