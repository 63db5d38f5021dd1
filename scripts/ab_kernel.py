#!/usr/bin/env python3
"""Time K1-K8 built from several source trees in one run.

Builds the kernel's source (``quad3d_substeps.cu`` for K1,
``quad3d_rollout.cu`` for K2,
``quad3d_policy_rollout.cu`` for K3, ``ppo_update.cu`` for K4,
``cartpole_rollout.cu`` for K5, ``cartpole_policy_rollout.cu`` for K6,
``quad_planar_rollout.cu`` for K7, ``quad_planar_policy_rollout.cu`` for
K8) of each
other ``csrc`` directory (for example the parent commit's, unpacked with
``git archive <commit> safe_control_gym_torch/csrc``) into a library of
its own, beside this tree's kernel library.  All run on the same input:
K1 one launch of config 4's substeps (dt 1/240, 4 RK4 substeps, actuation
on; ``--euler``, ``--no-actuation`` change them) on random states, thrusts
through both PWM clip limits and small external forces, in ``--dtype``
float32 or float64 (the float64 instance); BASELINE config 4 for K2 (one
call of 8192 hover steps; ``--maze``: config 5 on K2's maze instance, its
step noise on) and K3 (one call of
128 policy steps: the rl_train shapes, the normalized action space, weights
from a fixed seed, hidden width ``--hidden``), config 2 for K5 (one call of
8192 steps of a zero force under the config's action white noise) and
config 3 for K7 (one call of 4096 hover steps; ``--quad-type 1`` the 1D
quad on the same config), cartpole_stab for K6 and quad2d_stab for K8 (one
call of 128 policy steps each, the rl_train shapes as K3's; ``--quad-type
1`` the 1D quad; ``--disturbed`` adds action white noise and an impulse
and tracks the circle), at ``--batch`` envs (4096) from rows that have
already run two calls; K4 one minibatch of 131072 samples at H = 64
(``chip_smoke.k4_inputs``).  ``--steps`` sets another number of steps a
call for K2, K3, K5-K8.  Each round runs the others, this tree twice,
then the others in reverse (other, this, this, other for one other tree);
each call is timed alone with CUDA events, but K1's by the profiler's
device time over ``--launches`` (200) launches (CUDA events around
back-to-back launches from Python would time the host's ctypes launch
once K1 runs faster than it), beside an empty kernel's at the grid and
block of each build's launch (the floor of a launch).  K1, K2, K3, K5-K8
must leave the
same rows (and K3, K6 and K8 the same record) bit for bit; K4's builds may
sum in other orders (the kernel before the redesign has no FMA), so each
build must repeat its own gradients bit for bit and the largest difference
from the first other tree's is reported.  Prints each call's time, the
medians, their ratio to the first other tree, each build's registers, the
SM clock ``nvidia-smi`` read during the rounds, and the card as
``nvidia-smi`` names it.  With ``--sass-dir``, also the kernel's SASS
instruction count (``cuobjdump``) and its loops (each backward branch and
the instructions it spans), from which instructions per step are read.

The one-thread entry points of K1, K2, K3, K5-K8 (before their lane-group
redesigns) take no launch plan, and K2's before its maze instance no seed;
the script tells them apart by ``<entry>_api_version`` (absent: 1), as it
tells K4's by ``ppo_grads_api_version``.  ``--group NAME=G`` launches
the tree NAME (``this`` or an other's name) with G lanes per env, where its
build has that instance; else each tree takes its wrapper's plan.
``--block NAME=N`` launches K1 of the tree NAME with N threads a block in
place of its plan's (a sweep of the plan's block size).

    python3 scripts/ab_kernel.py --kernel k1|k2|k3|k4|k5|k6|k7|k8 --other NAME=DIR [--other ...]
        [--batch 4096] [--steps N] [--hidden 64] [--quad-type 2] [--disturbed] [--maze]
        [--dtype float32|float64] [--euler] [--no-actuation] [--launches 200]
        [--group NAME=G ...] [--block NAME=N ...] [--rounds 5] [--sass-dir DIR]
        [--out results.json]

Needs one CUDA card, ``nvcc`` and, for every kernel but K1 and K4, the
same parameter-struct size in every tree (checked), or for K2 and K3 an
other tree's struct no larger than this one's: the maze envelope's fields
were appended, so an older struct is a prefix of this one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Per kernel: source file, C entry point, the kernel function's name.
KERNELS = {"k1": ("quad3d_substeps.cu", "quad3d_substeps", "quad3d_substeps_kernel"),
           "k2": ("quad3d_rollout.cu", "quad3d_rollout", "quad3d_rollout_kernel"),
           "k3": ("quad3d_policy_rollout.cu", "quad3d_policy_rollout",
                  "quad3d_policy_rollout_kernel"),
           "k4": ("ppo_update.cu", "ppo_grads", "ppo_grads_kernel"),
           "k5": ("cartpole_rollout.cu", "cartpole_rollout", "cartpole_rollout_kernel"),
           "k6": ("cartpole_policy_rollout.cu", "cartpole_policy_rollout",
                  "cartpole_policy_rollout_kernel"),
           "k7": ("quad_planar_rollout.cu", "quad_planar_rollout", "quad_planar_rollout_kernel"),
           "k8": ("quad_planar_policy_rollout.cu", "quad_planar_policy_rollout",
                  "quad_planar_policy_rollout_kernel")}
STEPS = {"k1": 4, "k2": 8192, "k3": 128, "k4": 131072, "k5": 8192, "k6": 128, "k7": 4096,
         "k8": 128}  # K1: substeps; K4: samples
# The entry point that reports the size of a rollout kernel's parameter
# struct, and the source that defines it where that is another file.
PARAMS_SIZE = {"k2": "quad3d_rollout_params_size", "k3": "quad3d_rollout_params_size",
               "k5": "cartpole_params_size", "k6": "cartpole_params_size",
               "k7": "quad_planar_params_size", "k8": "quad_planar_params_size"}
PARAMS_SOURCE = {"k3": "quad3d_rollout.cu", "k6": "cartpole_rollout.cu",
                 "k8": "quad_planar_rollout.cu"}
_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# K1's entry points before the lane-group redesign (no
# quad3d_substeps_api_version): x, thrust, ext, mass, j, out, B, dt,
# dt_half, dt_sixth, n_sub, euler, g, l_sq2, km_over_kf, actuation, block,
# stream, the scalars in float or (the float64 instance) double.
K1_V1 = {"quad3d_substeps": [_P] * 6 + [_I, _F, _F, _F, _I, _I, _F, _F, _F, _I, _I, _P],
         "quad3d_substeps_f64": [_P] * 6 + [_I, _D, _D, _D, _I, _I, _D, _D, _D, _I, _I, _P]}
K1_V1_BLOCK = 64
# An empty kernel: the floor of one launch at a grid and block.
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void ab_empty_kernel() {}
extern "C" int ab_empty(int grid, int block, void* stream) {
  ab_empty_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
# K4's entry points before the redesign (no ppo_grads_api_version): nx, nu,
# H, mb, *ng, *nblk, *smem_bytes; and nx, nu, H, mb, relu, clip_lo, clip_hi,
# inv_n, mb_ptr, wflat, partial, out, nblk, smem_bytes, stream.
K4_V1 = {"ppo_grads_plan": [_I, _I, _I, _I, _P, _P, _P],
         "ppo_grads": [_I, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _I, _I, _P]}
# The rollout kernels' entry points before their redesigns (one thread per
# env), K2, K3, K5, K6, K7, K8: params, rows_in, action, rows_out, B,
# block, stream; params, normalized, relu, norm_act_scale, hover_thrust,
# hidden, seed, wflat, rows_in, rows_out, traj, B, stream; params, seed,
# rows_in, action, rows_out, B, block, stream; params, relu, hidden, seed,
# wflat, rows_in, rows_out, traj, B, stream; params, nx, seed, rows_in,
# action, rows_out, B, block, stream; and params, nx, relu, hidden, seed,
# wflat, rows_in, rows_out, traj, B, stream.
# K2's entry of API version 2 (the launch plan, no seed): params, rows_in,
# action, rows_out, B, group, block, grid, stream.
K2_V2 = {"quad3d_rollout": [_P, _P, _P, _P, _I, _I, _I, _I, _P]}
ROLLOUT_V1 = {"quad3d_rollout": [_P, _P, _P, _P, _I, _I, _P],
              "quad3d_policy_rollout": [_P, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P, _I, _P],
              "cartpole_rollout": [_P, _P, _P, _P, _P, _I, _I, _P],
              "cartpole_policy_rollout": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P],
              "quad_planar_rollout": [_P, _I, _P, _P, _P, _P, _I, _I, _P],
              "quad_planar_policy_rollout": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]}


class Named:
    """A library under one name of several: attribute reads go to it."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)


def api(lib, entry) -> int:
    """The version ``<entry>_api_version`` reports, 1 where it is absent."""
    try:
        fn = getattr(lib, f"{entry}_api_version")
    except AttributeError:
        return 1
    fn.restype = ctypes.c_int
    return fn()


def build_others(kernel: str, trees: dict, out_dir) -> dict:
    """The kernel's source of each other tree (name: csrc directory) as a
    shared library of its own, all nvcc processes started together (K3, K6
    and K8 need K2's, K5's and K7's source beside them for the parameter
    struct's size, PARAMS_SOURCE); a directory given under several names is
    built once.  A library whose sources and flags have not changed since
    an earlier run in the same directory is reused.  Returns name:
    (library, path, ptxas lines)."""
    from safe_control_gym_torch import kernels

    src, entry, _ = KERNELS[kernel]
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, first = {}, {}
    for name, csrc in trees.items():
        if csrc in first:  # the same tree under another name: one build
            procs[name] = procs[first[csrc]]
            continue
        first[csrc] = name
        so = out_dir / f"lib{kernel}_{name}.so"
        srcs = [os.path.join(csrc, src)] + ([os.path.join(csrc, PARAMS_SOURCE[kernel])]
                                            if kernel in PARAMS_SOURCE else [])
        h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS + tuple(srcs)).encode())
        for f in sorted(os.listdir(csrc)):
            h.update(f.encode() + open(os.path.join(csrc, f), "rb").read())
        stamp = so.with_suffix(".stamp")
        if so.exists() and stamp.exists() and stamp.read_text() == h.hexdigest():
            procs[name] = (so, stamp, None, None)
            continue
        procs[name] = (so, stamp, h.hexdigest(), subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", *srcs, "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, stamp, digest, proc) in procs.items():
        log = so.with_suffix(".log")
        if proc is not None and proc.returncode is None:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {kernel} of {name}:\n{text}")
            log.write_text(text)
            stamp.write_text(digest)
        regs = [line.strip() for line in log.read_text().splitlines()
                if "registers" in line or "spill" in line or "entry function" in line]
        lib = ctypes.CDLL(str(so))
        if kernel == "k4":
            sigs = kernels._SIGNATURES if api(lib, "ppo_grads") == 2 else K4_V1
            entries = ("ppo_grads_plan", "ppo_grads")
        elif kernel == "k1":
            sigs = kernels._SIGNATURES if api(lib, entry) == 2 else K1_V1
            entries = ("quad3d_substeps", "quad3d_substeps_f64")
        else:
            version = api(lib, entry)
            sigs = ROLLOUT_V1 if version == 1 else K2_V2 if (kernel, version) == ("k2", 2) \
                else kernels._SIGNATURES
            sigs = {**kernels._SIGNATURES, entry: sigs[entry]}
            entries = (entry, PARAMS_SIZE[kernel])
        for fn in entries:
            getattr(lib, fn).argtypes = sigs[fn]
            getattr(lib, fn).restype = ctypes.c_int
        out[name] = (lib, so, regs)
    return out


def prefer(kernel, hidden, nx, nu, group, dtype="float32", maze=False) -> list:
    """Mangled template arguments that begin the name of the instance the
    main path runs, the most specific first: K1's at the scalar type and
    the group size ``group`` (before its redesign: at the scalar type),
    K2's config-4 instance (with ``maze`` its maze instance; a build holds
    one group size; before the maze instance its one), K3's at H = 64 or
    else its run-time-width instance
    (H = 0), K4's at R = 2 with its weights in shared memory, K5's at the
    group size ``group``, K7's at (nx, nu) and ``group``, K6's and K8's at
    the width and ``group`` (before their redesigns: at the width); of K3,
    K6 and K8 the state-observation instance, not the observation instance
    (``Lb1E``) of later builds, and of K3 the instance without the maze
    (its second flag ``Lb0E``; the maze instances carry ``Lb1E``).  A
    kernel that is no template (K2 and K5 before their redesigns) has one
    instance."""
    h = 64 if hidden == 64 else 0
    t = {"float32": "f", "float64": "d"}[dtype]
    return {"k1": [f"I{t}Li{group}E", f"I{t}E"], "k2": [f"ILi4ELb{int(maze)}E", "ILi"],
            "k3": [f"ILi{h}ELi8ELb0ELb0E", f"ILi{h}ELi8ELb0EE", f"ILi{h}E"],
            "k4": ["ILi2ELb1E"],
            "k5": [f"ILi{group}E"],
            "k6": [f"ILi{h}ELi{group}ELb0E", f"ILi{h}ELi{group}E", f"ILi{h}E"],
            "k7": [f"ILi{nx}ELi{nu}ELi{group}E", f"ILi{nx}ELi{nu}E"],
            "k8": [f"ILi{nx}ELi{nu}ELi{h}ELi{group}ELb0E", f"ILi{nx}ELi{nu}ELi{h}ELi{group}E",
                   f"ILi{nx}ELi{nu}ELi{h}E"]}[kernel]


def sass_count(path, kname, prefs, out_file) -> dict:
    """Write the SASS of the kernel ``kname`` in ``path`` (the instance
    whose name goes on with the first of ``prefs`` that one has) to
    ``out_file``; return its number of instructions, its convergence
    regions (``BSSY``) and its loops (each backward branch: from, to,
    instructions spanned), the widest first."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    names = [f.splitlines()[0] for f in funcs[1:]]
    want = next((n for pref in prefs for n in names if kname + pref in n), kname)
    body = next(f for f, n in zip(funcs[1:], names) if want in n)
    with open(out_file, "w") as f:
        f.write(body)
    ins = [(int(a, 16), t.strip()) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    index = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, t) in enumerate(ins):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)\s*$", t)
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in index:
            loops.append((hex(a), m.group(1), i - index[int(m.group(1), 16)] + 1))
    loops.sort(key=lambda r: -r[2])
    return {"instance": want, "instructions": len(ins),
            "bssy": sum(1 for _, t in ins if t.startswith("BSSY")), "loops": loops[:8]}


def k4_launch(dev, stream):
    """K4's config-4 minibatch (mb = 131072, H = 64) and a launch of any
    library's build, through the entry points of its API version."""
    import torch

    from chip_smoke import k4_inputs, seeded_ac
    from safe_control_gym_torch.parallel import fast_update as U

    nx, nu, n = 12, 4, STEPS["k4"]
    ac = seeded_ac(dev, seed=1)
    with torch.no_grad():
        ac.logstd.copy_(torch.tensor([-0.5, -0.7, -0.3, -0.6], device=dev))
    mb = k4_inputs(dev, ac, n)
    w = U.prep_weights(ac.actor, ac.critic, ac.logstd)
    wflat = torch.cat([w[k].reshape(-1) for k in U.SEGMENTS])
    args = (1.0 - 0.2, 1.0 + 0.2, 1.0 / n)
    plans = {}

    def launch(lib, group):
        f32 = dict(dtype=torch.float32, device=dev)
        if api(lib, "ppo_grads") == 2:
            if id(lib) not in plans:
                plans[id(lib)] = plan = (ctypes.c_int * 8)()
                if lib.ppo_grads_plan(nx, nu, 64, n, plan):
                    raise RuntimeError("ppo_grads_plan failed")
            plan = plans[id(lib)]
            wpad, partial = torch.empty(plan[7], **f32), torch.empty(plan[1] * plan[0], **f32)
            out = torch.empty(plan[0], **f32)
            code = lib.ppo_grads(plan, nx, nu, 64, n, 0, *args, mb.data_ptr(), wflat.data_ptr(),
                                 wpad.data_ptr(), partial.data_ptr(), out.data_ptr(), stream)
        else:
            ng, nblk, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            if lib.ppo_grads_plan(nx, nu, 64, n, ctypes.byref(ng), ctypes.byref(nblk),
                                  ctypes.byref(smem)):
                raise RuntimeError("ppo_grads_plan failed")
            partial = torch.empty(nblk.value * ng.value, **f32)
            out = torch.empty(ng.value, **f32)
            code = lib.ppo_grads(nx, nu, 64, n, 0, *args, mb.data_ptr(), wflat.data_ptr(),
                                 partial.data_ptr(), out.data_ptr(), nblk.value, smem.value, stream)
        return code, (out,)

    return launch


def k1_launch(dev, B, n_sub, dtype, euler, actuation, stream, blocks=None):
    """K1's input at B envs (random states, thrusts through both PWM clip
    limits, small external forces; chip_smoke.phase_k1's distributions) in
    ``dtype``, and a launch of any library's build through the entry point
    of its API version, with ``group`` lanes per env (None: this tree's
    plan) and ``blocks[lib]`` threads a block where given.  Returns the
    launch and the (grid, block) it takes for a build of API version 1 and
    2 at a group."""
    import torch

    from safe_control_gym_torch.ops import quad_substeps as Q

    rng = np.random.default_rng(0)
    tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    x = torch.tensor(rng.standard_normal((B, 12)) * 0.2, dtype=tdt, device=dev)
    thr = torch.tensor(rng.uniform(0.0, 0.16, (B, 4)), dtype=tdt, device=dev)
    ext = torch.tensor(rng.standard_normal((B, 3)) * 1e-3, dtype=tdt, device=dev)
    m = torch.full((B,), 0.027, dtype=tdt, device=dev)
    j = torch.tensor([1.4e-5, 1.4e-5, 2.17e-5], dtype=tdt, device=dev).repeat(B, 1)
    dt = 1 / 240
    cast = Q._f32 if dtype == "float32" else float
    scalars = (cast(dt), cast(dt / 2), cast(dt / 6), n_sub, int(euler), cast(Q.GRAVITY),
               cast(Q.ARM_L / (2.0**0.5)), cast(Q.KM_OVER_KF), int(actuation))
    entry = "quad3d_substeps" if dtype == "float32" else "quad3d_substeps_f64"
    ins = (x, thr, ext, m, j)  # held by the closures below: their memory must stay theirs
    out = torch.empty_like(x)

    def plan(lib, group):
        g, block, grid = Q.launch_plan(B, tdt, group)
        block = (blocks or {}).get(id(lib), block)
        return g, block, -(-B // (block // g))

    def geometry(lib, group):
        if api(lib, "quad3d_substeps") == 1:
            return -(-B // K1_V1_BLOCK), K1_V1_BLOCK
        _, block, grid = plan(lib, group)
        return grid, block

    def launch(lib, group):
        if api(lib, "quad3d_substeps") == 1:
            code = getattr(lib, entry)(*(a.data_ptr() for a in ins), out.data_ptr(), B, *scalars,
                                       K1_V1_BLOCK, stream)
        else:
            code = getattr(lib, entry)(*(a.data_ptr() for a in ins), out.data_ptr(), B, *scalars,
                                       *plan(lib, group), stream)
        return code, (out,)

    return launch, geometry


def inputs(kernel, dev, B, steps, hidden, quad_type, disturbed=False, dtype="float32",
           euler=False, actuation=True, launches=200, blocks=None, maze=False):
    """The kernel's input at the main path's shapes (B envs, ``steps``
    steps a call, K3, K6 and K8 at width ``hidden``, K7 and K8 on the quad
    type ``quad_type``, K6 and K8 ``disturbed`` or not) and a function that
    launches a library's build of it with ``group`` lanes per env (None:
    the wrapper's plan), returning (ms, outputs); K1 on its own input
    (:func:`k1_launch`, ``steps`` substeps), its ms the profiler's mean
    device time over ``launches`` launches, ``blocks`` the threads a block
    by library where not the plan's."""
    import torch

    from chip_smoke import seeded_ac
    from safe_control_gym_torch import kernels
    from safe_control_gym_torch.baseline import cfg4, cfg5
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_env as F
    from safe_control_gym_torch.parallel import fast_policy as P

    stream = kernels.stream_ptr(dev)
    if kernel == "k1":
        from chip_smoke import kernel_device_ms

        launch, _ = k1_launch(dev, B, steps, dtype, euler, actuation, stream, blocks)

        def call(lib, group):
            def fn():
                kernels.check(launch(lib, group)[0], kernel)

            ms = kernel_device_ms(fn, KERNELS["k1"][2], launches)
            _, outs = launch(lib, group)
            torch.cuda.synchronize()
            return ms, tuple(o.clone() for o in outs)

        return call
    if kernel == "k4":
        launch = k4_launch(dev, stream)
    elif kernel in ("k5", "k7"):
        launch = planar_launch(kernel, dev, B, steps, quad_type, stream)
    elif kernel in ("k6", "k8"):
        launch = planar_policy_launch(kernel, dev, B, steps, hidden, quad_type, disturbed, stream)
    elif kernel == "k2":
        env = make_quadrotor(cfg5() if maze else cfg4(), device=dev)
        fr = F.FastQuadRollout(env, B, steps_per_call=steps, device=dev)
        act = fr.prepare_action(np.full(4, float(env.u_goal[0])))
        rows_in = fr.run(fr.run(fr.reset(seed=0), act, seed=1), act, seed=2)
        seed = torch.tensor([3], dtype=torch.int32, device=dev)
        params = F.kernel_params(fr.params)

        def launch(lib, group):
            out = torch.empty_like(rows_in)
            args = (rows_in.data_ptr(), act.data_ptr(), out.data_ptr(), B)
            version = api(lib, "quad3d_rollout")
            if version == 1:
                code = lib.quad3d_rollout(ctypes.addressof(params), *args, 64, stream)
            elif version == 2:
                code = lib.quad3d_rollout(ctypes.addressof(params), *args,
                                          *F.launch_plan(B, group), stream)
            else:
                code = lib.quad3d_rollout(ctypes.addressof(params), seed.data_ptr(), *args,
                                          *F.launch_plan(B, group), stream)
            return code, (out,)
    else:
        env = make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev)
        fp = P.FastPolicyRollout(env, B, steps, mlp_hidden=hidden, device=dev)
        ac = seeded_ac(dev, hidden=hidden)
        w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
        rows_in = fp.run(fp.run(fp.reset(seed=0), w, seed=1)[0], w, seed=2)[0]
        wflat = P.kernel_weights(w)
        seed = torch.tensor([3], dtype=torch.int32, device=dev)
        params = F.kernel_params(fp.params)
        p = fp.params

        def launch(lib, group):
            out = torch.empty_like(rows_in)
            traj = torch.empty((steps, P.TRAJ_ROWS, B), device=dev)
            args = (ctypes.addressof(params), int(p["normalized"]), 0, float(p["norm_act_scale"]),
                    float(p["hover_thrust"]), hidden, seed.data_ptr(), wflat.data_ptr(),
                    rows_in.data_ptr(), out.data_ptr(), traj.data_ptr(), B)
            if api(lib, "quad3d_policy_rollout") == 1:
                code = lib.quad3d_policy_rollout(*args, stream)
            else:
                code = lib.quad3d_policy_rollout(*args, *P.launch_plan(B, hidden, group), stream)
            return code, (out, traj)

    def call(lib, group):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if kernel == "k4":  # keeps the device busy while the timed launch is enqueued
            launch(lib, group)
        start.record()
        code, outs = launch(lib, group)
        end.record()
        torch.cuda.synchronize()
        kernels.check(code, kernel)
        return start.elapsed_time(end), outs

    return call


def planar_launch(kernel, dev, B, steps, quad_type, stream):
    """K5 on config 2 (a zero force under its action white noise) or K7 on
    config 3 (hover thrust, quad type ``quad_type``), from rows that have
    run two calls, and a launch of any library's build through the entry
    point of its API version."""
    import torch

    from safe_control_gym_torch.baseline import cfg_cartpole, cfg_quad2d
    from safe_control_gym_torch.envs.cartpole import make_cartpole
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_cartpole as FC
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    if kernel == "k5":
        fr = FC.FastCartPoleRollout(make_cartpole(cfg_cartpole(), device=dev), B,
                                    steps_per_call=steps, device=dev)
        act = fr.prepare_action(0.0)
        params, entry, nx_arg, plan = FC.kernel_params(fr.params), "cartpole_rollout", (), \
            (lambda g: FC.launch_plan(B, g))
    else:
        env = make_quadrotor(cfg_quad2d(quad_type=quad_type), device=dev)
        fr = PQ.FastPlanarQuadRollout(env, B, steps_per_call=steps, device=dev)
        act = fr.prepare_action(np.full(fr.nu, float(env.u_goal[0]), np.float32))
        params, entry, nx_arg = PQ.kernel_params(fr.params), "quad_planar_rollout", (fr.nx,)
        plan = lambda g: PQ.launch_plan(B, fr.nx, g)  # noqa: E731
    rows_in = fr.run(fr.run(fr.reset(seed=0), act, seed=1), act, seed=2)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)

    def launch(lib, group):
        out = torch.empty_like(rows_in)
        args = (ctypes.addressof(params), *nx_arg, seed.data_ptr(), rows_in.data_ptr(),
                act.data_ptr(), out.data_ptr(), B)
        if api(lib, entry) == 1:
            code = getattr(lib, entry)(*args, 64, stream)
        else:
            code = getattr(lib, entry)(*args, *plan(group), stream)
        return code, (out,)

    return launch


def planar_policy_launch(kernel, dev, B, steps, hidden, quad_type, disturbed, stream):
    """K6 on cartpole_stab or K8 on quad2d_stab (quad type ``quad_type``) at
    the rl_train shapes, weights of width ``hidden`` from a fixed seed, from
    rows that have run two calls; ``disturbed`` adds action white noise and
    an impulse and tracks the circle.  Returns a launch of any library's
    build through the entry point of its API version."""
    import torch

    from chip_smoke import seeded_ac
    from safe_control_gym_torch.baseline import cfg_cartpole_rl, cfg_quad2d_rl
    from safe_control_gym_torch.envs.cartpole import make_cartpole
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_cartpole as FC
    from safe_control_gym_torch.parallel import fast_policy as P
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    kw = dict(task="traj_tracking", task_info={"trajectory_type": "circle",
                                                "trajectory_plane": "xz"}) if disturbed else {}
    if kernel == "k6":
        if disturbed:
            kw["disturbances"] = {"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.4,
                                                "duration": 4, "decay_rate": 0.8},),
                                  "action": ({"disturbance_func": "white_noise", "std": 0.2},)}
        fp = FC.FastCartPolePolicyRollout(make_cartpole(cfg_cartpole_rl(**kw), device=dev), B,
                                          steps, mlp_hidden=hidden, device=dev)
        params, entry, nx_arg = FC.kernel_params(fp.params), "cartpole_policy_rollout", ()
        plan = lambda g: FC.policy_launch_plan(B, hidden, g)  # noqa: E731
    else:
        if disturbed:
            kw["disturbances"] = {"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.02,
                                                "duration": 4, "decay_rate": 0.8},),
                                  "action": ({"disturbance_func": "white_noise", "std": 0.01},)}
        env = make_quadrotor(cfg_quad2d_rl(quad_type=quad_type, **kw), device=dev)
        fp = PQ.FastPlanarQuadPolicyRollout(env, B, steps, mlp_hidden=hidden, device=dev)
        params, entry, nx_arg = PQ.kernel_params(fp.params), "quad_planar_policy_rollout", \
            (fp.nx,)
        plan = lambda g: PQ.policy_launch_plan(B, hidden, fp.nx, g)  # noqa: E731
    ac = seeded_ac(dev, nx=fp.obs_dim, nu=fp.nu, hidden=hidden)
    w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
    rows_in = fp.run(fp.run(fp.reset(seed=0), w, seed=1)[0], w, seed=2)[0]
    wflat = P.kernel_weights(w)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)

    def launch(lib, group):
        out = torch.empty_like(rows_in)
        traj = torch.empty((steps, fp.traj_rows, B), device=dev)
        args = (ctypes.addressof(params), *nx_arg, 0, hidden, seed.data_ptr(), wflat.data_ptr(),
                rows_in.data_ptr(), out.data_ptr(), traj.data_ptr(), B)
        if api(lib, entry) == 1:
            code = getattr(lib, entry)(*args, stream)
        else:
            code = getattr(lib, entry)(*args, *plan(group), stream)
        return code, (out, traj)

    return launch


def default_group(kernel, nx, B, hidden, dtype="float32"):
    """The group size of the wrapper's plan at B envs for K1 and K5-K8 (the
    instance whose SASS is dumped), None for the others."""
    import torch

    from safe_control_gym_torch.ops import quad_substeps as Q
    from safe_control_gym_torch.parallel import fast_cartpole as FC
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    return {"k1": lambda: Q.launch_plan(B, getattr(torch, dtype))[0],
            "k5": lambda: FC.launch_plan(B)[0], "k7": lambda: PQ.launch_plan(B, nx)[0],
            "k6": lambda: FC.policy_launch_plan(B, hidden)[0],
            "k8": lambda: PQ.policy_launch_plan(B, hidden, nx)[0]}.get(kernel, lambda: None)()


def empty_floor(dev, B, n_sub, args, libs, groups, blocks) -> dict:
    """The profiler's mean device time of an empty kernel (EMPTY_SOURCE,
    built here) at the grid and block of each build's K1 launch at B envs:
    {name: {"grid", "block", "ms"}}."""
    from chip_smoke import kernel_device_ms
    from safe_control_gym_torch import kernels

    out_dir = kernels.BUILD / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "ab_empty.cu", out_dir / "libab_empty.so"
    src.write_text(EMPTY_SOURCE)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(src), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.ab_empty.argtypes, lib.ab_empty.restype = [_I, _I, _P], ctypes.c_int
    stream = kernels.stream_ptr(dev)
    _, geometry = k1_launch(dev, B, n_sub, args.dtype, args.euler, not args.no_actuation, stream,
                            blocks)
    out = {}
    for k, klib in libs.items():
        grid, block = geometry(klib, groups.get(k))

        def fn(grid=grid, block=block):
            kernels.check(lib.ab_empty(grid, block, stream), "ab_empty")

        ms = kernel_device_ms(fn, "ab_empty_kernel", args.launches)
        out[k] = {"grid": grid, "block": block, "ms": ms}
    return out


def sm_clock_sampler():
    """Start ``nvidia-smi`` sampling the SM clock (MHz) every 100 ms; the
    returned function stops it and gives the samples."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                             "-lms", "100"], stdout=subprocess.PIPE, text=True)

    def stop():
        proc.terminate()
        out, _ = proc.communicate()
        return [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]

    return stop


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k2")
    ap.add_argument("--other", action="append", required=True, metavar="NAME=DIR",
                    help="csrc directory of another tree, under a name")
    ap.add_argument("--batch", type=int, default=4096, help="envs of a call")
    ap.add_argument("--steps", type=int, help="steps of a call (default: the main path's)")
    ap.add_argument("--hidden", type=int, default=64, help="K3's, K6's and K8's hidden width")
    ap.add_argument("--quad-type", type=int, choices=(1, 2), default=2,
                    help="K7's and K8's quad type (config 3 is the 2D quad)")
    ap.add_argument("--disturbed", action="store_true",
                    help="K6 and K8 with action white noise and an impulse, tracking the circle")
    ap.add_argument("--maze", action="store_true",
                    help="K2 on config 5 (its maze instance; trees whose K2 has one)")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                    help="K1's instance")
    ap.add_argument("--euler", action="store_true", help="K1 with Euler substeps, not RK4")
    ap.add_argument("--no-actuation", action="store_true",
                    help="K1 takes the thrusts as forces")
    ap.add_argument("--launches", type=int, default=200,
                    help="K1's launches a timed call (the profiler's mean)")
    ap.add_argument("--group", action="append", default=[], metavar="NAME=G",
                    help="lanes per env for the tree NAME's launch")
    ap.add_argument("--block", action="append", default=[], metavar="NAME=N",
                    help="K1: threads a block for the tree NAME's launch (default: the plan's)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--sass-dir", help="write each build's kernel SASS here")
    ap.add_argument("--out", help="also write the results here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_kernel: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line
    from safe_control_gym_torch import kernels

    kernel = args.kernel
    src, _, kname = KERNELS[kernel]
    B, steps = args.batch, args.steps or STEPS[kernel]
    groups = {k: int(v) for k, v in (g.split("=", 1) for g in args.group)}
    dev = torch.device("cuda")
    trees = {name: os.path.abspath(csrc) for name, csrc in (o.split("=", 1) for o in args.other)}
    built = build_others(kernel, trees, kernels.BUILD / "ab")
    libs = {k: v[0] for k, v in built.items()}
    paths = {k: v[1] for k, v in built.items()}
    regs = {k: v[2] for k, v in built.items()}
    others = list(libs)
    libs["this"], paths["this"] = kernels.lib(), kernels.BUILD / src.replace(".cu", ".o")
    regs["this"] = [line.strip() for line in (kernels.BUILD / "ptxas.log").read_text()
                    .split(f"== {src}")[1].split("==")[0].splitlines()
                    if "registers" in line or "spill" in line]
    if kernel == "k1":  # this tree's K1 entry points by API version too
        sigs = kernels._SIGNATURES if api(libs["this"], "quad3d_substeps") == 2 else K1_V1
        for fn in ("quad3d_substeps", "quad3d_substeps_f64"):
            getattr(libs["this"], fn).argtypes = sigs[fn]
    if kernel in PARAMS_SIZE:
        sizes = {k: getattr(lib, PARAMS_SIZE[kernel])() for k, lib in libs.items()}
        # K2's and K3's struct gained the maze fields at its end: an older
        # tree reads the prefix it knows.
        prefix_ok = kernel in ("k2", "k3") and max(sizes.values()) == sizes["this"]
        if len(set(sizes.values())) != 1 and not prefix_ok:
            raise RuntimeError(f"parameter structs differ in size between the trees: {sizes}")
    nx, nu = {1: (2, 1), 2: (6, 2)}[args.quad_type]
    sass = {}
    if args.sass_dir:
        os.makedirs(args.sass_dir, exist_ok=True)
        sass = {k: sass_count(p, kname, prefer(kernel, args.hidden, nx, nu,
                                               groups.get(k)
                                               or default_group(kernel, nx, B, args.hidden,
                                                                args.dtype),
                                               args.dtype, args.maze),
                              os.path.join(args.sass_dir, f"{kernel}_{k}.sass"))
                for k, p in paths.items()}

    # A library built once for several names is one object: key the
    # blocks by name through a wrapper per name.
    blocks = {}
    for name, n in (b.split("=", 1) for b in args.block):
        libs[name] = Named(libs[name])
        blocks[id(libs[name])] = int(n)
    call = inputs(kernel, dev, B, steps, args.hidden, args.quad_type, args.disturbed, args.dtype,
                  args.euler, not args.no_actuation, args.launches, blocks, args.maze)
    floor = empty_floor(dev, B, steps, args, libs, groups, blocks) if kernel == "k1" else {}

    def equal(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))

    first = {k: call(lib, groups.get(k))[1] for k, lib in libs.items()}  # warm-up of each library
    # The rollout kernels' builds must leave the first other tree's outputs
    # bit for bit; each K4 build its own first launch's.
    want = {k: first[k] if kernel == "k4" else first[others[0]] for k in libs}
    same = {k: equal(want[k], first[k]) for k in libs}
    err = {k: max(float((x.double() - y.double()).abs().nan_to_num(0.0).max())  # NaN seed bits
                  for x, y in zip(first[k], first[others[0]])) for k in libs}
    order = others + ["this", "this"] + others[::-1]
    ms = {k: [] for k in libs}
    stop_clock = sm_clock_sampler()
    for _ in range(args.rounds):
        for k in order:
            t, out = call(libs[k], groups.get(k))
            ms[k].append(t)
            same[k] = same[k] and equal(want[k], out)
    clocks = stop_clock()
    med = {k: statistics.median(v) for k, v in ms.items()}
    base = med[others[0]]
    res = {"card": card_line(), "kernel": kernel, "B": B, "steps": steps,
           "hidden": args.hidden if kernel in ("k3", "k6", "k8") else None,
           "quad_type": args.quad_type if kernel in ("k7", "k8") else None,
           "disturbed": args.disturbed if kernel in ("k6", "k8") else None,
           "maze": args.maze if kernel == "k2" else None, "groups": groups,
           "k1": {"dtype": args.dtype, "euler": args.euler, "actuation": not args.no_actuation,
                  "launches": args.launches, "blocks": args.block,
                  "empty_kernel_ms": floor} if kernel == "k1" else None,
           "rounds": args.rounds, "order": order, "ms": ms, "median_ms": med,
           "over_first_other": {k: v / base for k, v in med.items()},
           "sm_clock_mhz": {"median": statistics.median(clocks) if clocks else None,
                            "min": min(clocks, default=None), "max": max(clocks, default=None),
                            "samples": len(clocks)},
           "ptxas": regs, "sass": sass, "bit_equal": same, "max_abs_err_vs_first_other": err}
    print(res["card"])
    print(f"SM clock during the rounds: {res['sm_clock_mhz']}")
    if floor:
        print(f"empty kernel at each build's grid and block: {floor}")
    what = "substeps, " + args.dtype + (", Euler" if args.euler else ", RK4") + \
        ("" if not args.no_actuation else ", no actuation") if kernel == "k1" else "steps"
    for k in libs:
        print(f"{kernel.upper()} {k}: median {med[k]:.6f} ms per call of {steps} {what} at B={B}"
              + (f", H={args.hidden}" if kernel in ("k3", "k6", "k8") else "")
              + (f", {args.quad_type}D" if kernel in ("k7", "k8") else "")
              + (", disturbed" if args.disturbed and kernel in ("k6", "k8") else "")
              + (f", G={groups[k]}" if k in groups else "")
              + "".join(f", block {b.split('=', 1)[1]}" for b in args.block
                        if b.split("=", 1)[0] == k)
              + f" ({med[k] / base:.4f} of {others[0]}); bit-equal {same[k]}; max_abs_err "
              f"{err[k]:.3g} from {others[0]}; SASS {sass.get(k, 'not dumped')}; {regs[k]}; "
              f"calls {[round(t, 4) for t in ms[k]]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if not all(same.values()):
        print(f"ab_kernel: the {kernel} builds disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"total {time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
