#!/usr/bin/env python3
"""Time K2 or K3 built from several source trees in one run.

Builds the kernel's source (``quad3d_rollout.cu`` for K2,
``quad3d_policy_rollout.cu`` for K3) of each other ``csrc`` directory (for
example the parent commit's, unpacked with ``git archive <commit>
safe_control_gym_torch/csrc``) into a library of its own, beside this
tree's kernel library.  All run on the same input, BASELINE config 4 at
B = 4096 from rows that have already run two calls: K2 one call of 8192
hover steps; K3 one call of 128 policy steps (the rl_train shapes, the
normalized action space, weights from a fixed seed).  Each round runs the
others, this tree twice, then the others in reverse (other, this, this,
other for one other tree); each call is timed alone with CUDA events.  All
must leave the same rows (and K3 the same record) bit for bit.  Prints
each call's time, the medians, their ratio to the first other tree, each
build's registers and, with ``--sass-dir``, the kernel's SASS instruction
count (``cuobjdump``), and the card as ``nvidia-smi`` names it.

    python3 scripts/ab_kernel.py --kernel k2|k3 --other NAME=DIR [--other NAME=DIR ...]
        [--rounds 5] [--sass-dir DIR] [--out results.json]

Needs one CUDA card, ``nvcc`` and the same ``RolloutParams`` size in every
tree (checked).
"""

from __future__ import annotations

import argparse
import ctypes
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
B = 4096
# Per kernel: source file, C entry point, the kernel function's name.
KERNELS = {"k2": ("quad3d_rollout.cu", "quad3d_rollout", "quad3d_rollout_kernel"),
           "k3": ("quad3d_policy_rollout.cu", "quad3d_policy_rollout",
                  "quad3d_policy_rollout_kernel")}
STEPS = {"k2": 8192, "k3": 128}


def build_other(kernel: str, name: str, csrc: str, out_dir):
    """The kernel's source of another tree as its own shared library (K3's
    needs the K2 source beside it for quad3d_rollout_params_size)."""
    from safe_control_gym_torch import kernels

    src, entry, _ = KERNELS[kernel]
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{kernel}_{name}.so"
    srcs = [os.path.join(csrc, src)] + ([os.path.join(csrc, "quad3d_rollout.cu")]
                                        if kernel == "k3" else [])
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", *srcs, "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {kernel} of {name}:\n{res.stdout}{res.stderr}")
    regs = [line.strip() for line in (res.stdout + res.stderr).splitlines()
            if "registers" in line or "spill" in line or "entry function" in line]
    lib = ctypes.CDLL(str(so))
    getattr(lib, entry).argtypes = kernels._SIGNATURES[entry]
    getattr(lib, entry).restype = ctypes.c_int
    lib.quad3d_rollout_params_size.argtypes = []
    lib.quad3d_rollout_params_size.restype = ctypes.c_int
    return lib, so, regs


def sass_count(path, kname, out_file) -> int:
    """Write the SASS of the kernel ``kname`` in ``path`` to ``out_file``;
    return its number of instructions."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next(f for f in funcs[1:] if kname in f.splitlines()[0])
    with open(out_file, "w") as f:
        f.write(body)
    return len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[^ ;]", body))


def inputs(kernel, dev):
    """The kernel's input at the main path's shapes and a function that
    launches a library's build of it, returning (ms, outputs)."""
    import torch

    from chip_smoke import cfg4, seeded_ac
    from safe_control_gym_torch import kernels
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_env as F
    from safe_control_gym_torch.parallel import fast_policy as P

    stream = kernels.stream_ptr(dev)
    if kernel == "k2":
        env = make_quadrotor(cfg4(), device=dev)
        fr = F.FastQuadRollout(env, B, steps_per_call=STEPS[kernel], device=dev)
        act = fr.prepare_action(np.full(4, float(env.u_goal[0])))
        rows_in = fr.run(fr.run(fr.reset(seed=0), act), act)
        params = F.kernel_params(fr.params)

        def launch(lib):
            out = torch.empty_like(rows_in)
            code = lib.quad3d_rollout(ctypes.addressof(params), rows_in.data_ptr(),
                                      act.data_ptr(), out.data_ptr(), B, F.BLOCK, stream)
            return code, (out,)
    else:
        env = make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev)
        fp = P.FastPolicyRollout(env, B, STEPS[kernel], device=dev)
        ac = seeded_ac(dev)
        w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
        rows_in = fp.run(fp.run(fp.reset(seed=0), w, seed=1)[0], w, seed=2)[0]
        wflat = P.kernel_weights(w)
        seed = torch.tensor([3], dtype=torch.int32, device=dev)
        params = F.kernel_params(fp.params)
        p = fp.params

        def launch(lib):
            out = torch.empty_like(rows_in)
            traj = torch.empty((STEPS[kernel], P.TRAJ_ROWS, B), device=dev)
            code = lib.quad3d_policy_rollout(
                ctypes.addressof(params), int(p["normalized"]), 0, float(p["norm_act_scale"]),
                float(p["hover_thrust"]), P.HIDDEN, seed.data_ptr(), wflat.data_ptr(),
                rows_in.data_ptr(), out.data_ptr(), traj.data_ptr(), B, stream)
            return code, (out, traj)

    def call(lib):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        code, outs = launch(lib)
        end.record()
        torch.cuda.synchronize()
        kernels.check(code, kernel)
        return start.elapsed_time(end), outs

    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k2")
    ap.add_argument("--other", action="append", required=True, metavar="NAME=DIR",
                    help="csrc directory of another tree, under a name")
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
    dev = torch.device("cuda")
    libs, paths, regs = {}, {}, {}
    for spec in args.other:
        name, csrc = spec.split("=", 1)
        libs[name], paths[name], regs[name] = build_other(kernel, name, os.path.abspath(csrc),
                                                          kernels.BUILD / "ab")
    others = list(libs)
    libs["this"], paths["this"] = kernels.lib(), kernels.BUILD / src.replace(".cu", ".o")
    regs["this"] = [line.strip() for line in (kernels.BUILD / "ptxas.log").read_text()
                    .split(f"== {src}")[1].split("==")[0].splitlines()
                    if "registers" in line or "spill" in line]
    sizes = {k: lib.quad3d_rollout_params_size() for k, lib in libs.items()}
    if len(set(sizes.values())) != 1:
        raise RuntimeError(f"RolloutParams differ in size between the trees: {sizes}")
    sass = {}
    if args.sass_dir:
        os.makedirs(args.sass_dir, exist_ok=True)
        sass = {k: sass_count(p, kname, os.path.join(args.sass_dir, f"{kernel}_{k}.sass"))
                for k, p in paths.items()}

    call = inputs(kernel, dev)

    def equal(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))

    _, ref = call(libs[others[0]])
    same = {k: True for k in libs}
    for k, lib in libs.items():  # warm-up of each library
        same[k] = equal(ref, call(lib)[1])
    order = others + ["this", "this"] + others[::-1]
    ms = {k: [] for k in libs}
    for _ in range(args.rounds):
        for k in order:
            t, out = call(libs[k])
            ms[k].append(t)
            same[k] = same[k] and equal(ref, out)
    med = {k: statistics.median(v) for k, v in ms.items()}
    base = med[others[0]]
    res = {"card": card_line(), "kernel": kernel, "B": B, "steps": STEPS[kernel],
           "rounds": args.rounds, "order": order, "ms": ms, "median_ms": med,
           "over_first_other": {k: v / base for k, v in med.items()},
           "ptxas": regs, "sass_instructions": sass, "bit_equal": same}
    print(res["card"])
    for k in libs:
        print(f"{kernel.upper()} {k}: median {med[k]:.4f} ms per call of {STEPS[kernel]} steps "
              f"({med[k] / base:.4f} of {others[0]}); bit-equal {same[k]}; "
              f"SASS {sass.get(k, 'not dumped')}; {regs[k]}; calls {[round(t, 4) for t in ms[k]]}")
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
