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
6. prints one JSON line of per-kernel results, then the final status line.

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
    """All 27 rows of K2's output against its plain version's on the same
    input rows; returns the largest absolute difference on the float rows."""
    import torch

    diff = (out[K2_EXACT_ROWS] != ref[K2_EXACT_ROWS]).any(0)
    done_k, done_p = int(out[21].sum()), int(ref[21].sum())
    check(f"K2 {tag}: step, offset, done and episode rows", not bool(diff.any()) and done_k > 0,
          f"episodes {done_k} vs {done_p}; {int(diff.sum())} envs differ (exact)")
    seed = rows_in[25].view(torch.int32)
    check(f"K2 {tag}: seed row bits", torch.equal(out[25].view(torch.int32), seed)
          and torch.equal(ref[25].view(torch.int32), seed), "copied through unchanged")
    errs = []
    for what, rs, rtol, atol in K2_CLOSE_ROWS:
        err = max_err(out[rs], ref[rs])
        errs.append(err)
        check(f"K2 {tag}: {what}", bool(torch.isclose(out[rs], ref[rs], rtol=rtol, atol=atol).all()),
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
    err = check_k2_rows(f"vs plain (B={CHECK_B}, {CHECK_STEPS} steps)", out, ref, rows0)
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
        f"vs plain on the main path (B={B_MAIN}, {FAST_STEPS} steps)", rows, rows_plain, rows_in)

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
    out = {}
    for name, nbytes, ops in (("k1", k1_bytes, k1_ops), ("k2", k2_bytes, k2_ops)):
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
    ]}
    total_s = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s, "total_s": total_s,
                       "k1_max_abs_err": k1_errs, "k2_vs_plain_max_abs_err": k2_err,
                       "k2_vs_general_max_abs_err": cross_err, "bounds": bnd,
                       **res, **kernels_line}, f, indent=1, default=str)
    print(f"total {total_s:.1f} s")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
