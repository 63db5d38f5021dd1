#!/usr/bin/env python3
"""Time K2 (the whole-rollout kernel) built from several source trees in one run.

Builds ``quad3d_rollout.cu`` of each other ``csrc`` directory (for example
the parent commit's, unpacked with ``git archive <commit>
safe_control_gym_torch/csrc``) into a library of its own, beside this
tree's kernel library.  All run on the same input: BASELINE config 4 at
B = 4096, one call of 8192 hover steps, from rows that have already run two
such calls.  Each round runs the others, this tree twice, then the others in
reverse (other, this, this, other for one other tree); each call is timed
alone with CUDA events.  All must leave the same rows bit for bit.  Prints
each call's time, the medians, their ratio to the first other tree, each
build's registers and, with ``--sass-dir``, the kernel's SASS instruction
count (``cuobjdump``), and the card as ``nvidia-smi`` names it.

    python3 scripts/ab_k2.py --other NAME=DIR [--other NAME=DIR ...]
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
B, STEPS = 4096, 8192


def build_other(name: str, csrc: str, out_dir):
    """``quad3d_rollout.cu`` of another tree as its own shared library."""
    from safe_control_gym_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libk2_{name}.so"
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                          os.path.join(csrc, "quad3d_rollout.cu"), "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on K2 of {name}:\n{res.stdout}{res.stderr}")
    regs = [line.strip() for line in (res.stdout + res.stderr).splitlines()
            if "registers" in line or "spill" in line]
    lib = ctypes.CDLL(str(so))
    lib.quad3d_rollout.argtypes = kernels._SIGNATURES["quad3d_rollout"]
    lib.quad3d_rollout.restype = ctypes.c_int
    lib.quad3d_rollout_params_size.argtypes = []
    lib.quad3d_rollout_params_size.restype = ctypes.c_int
    return lib, so, regs


def sass_count(path, out_file) -> int:
    """Write the SASS of ``quad3d_rollout_kernel`` in ``path`` to
    ``out_file``; return its number of instructions."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next(f for f in funcs[1:] if "quad3d_rollout_kernel" in f.splitlines()[0])
    with open(out_file, "w") as f:
        f.write(body)
    return len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[^ ;]", body))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", required=True, metavar="NAME=DIR",
                    help="csrc directory of another tree, under a name")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--sass-dir", help="write each build's K2 SASS here")
    ap.add_argument("--out", help="also write the results here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_k2: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, cfg4
    from safe_control_gym_torch import kernels
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_env as F

    dev = torch.device("cuda")
    libs, paths, regs = {}, {}, {}
    for spec in args.other:
        name, csrc = spec.split("=", 1)
        libs[name], paths[name], regs[name] = build_other(name, os.path.abspath(csrc),
                                                          kernels.BUILD / "ab_k2")
    others = list(libs)
    libs["this"], paths["this"] = kernels.lib(), kernels.BUILD / "quad3d_rollout.o"
    regs["this"] = [line.strip() for line in (kernels.BUILD / "ptxas.log").read_text()
                    .split("== quad3d_rollout.cu")[1].split("==")[0].splitlines()
                    if "registers" in line or "spill" in line]
    sizes = {k: lib.quad3d_rollout_params_size() for k, lib in libs.items()}
    if len(set(sizes.values())) != 1:
        raise RuntimeError(f"RolloutParams differ in size between the trees: {sizes}")
    sass = {}
    if args.sass_dir:
        os.makedirs(args.sass_dir, exist_ok=True)
        sass = {k: sass_count(p, os.path.join(args.sass_dir, f"k2_{k}.sass"))
                for k, p in paths.items()}

    env = make_quadrotor(cfg4(), device=dev)
    fr = F.FastQuadRollout(env, B, steps_per_call=STEPS, device=dev)
    act = fr.prepare_action(np.full(4, float(env.u_goal[0])))
    rows_in = fr.run(fr.run(fr.reset(seed=0), act), act)
    params = F.kernel_params(fr.params)
    stream = kernels.stream_ptr(dev)

    def call(lib):
        out = torch.empty_like(rows_in)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        code = lib.quad3d_rollout(ctypes.addressof(params), rows_in.data_ptr(), act.data_ptr(),
                                  out.data_ptr(), B, F.BLOCK, stream)
        end.record()
        torch.cuda.synchronize()
        kernels.check(code, "quad3d_rollout")
        return start.elapsed_time(end), out

    _, ref = call(libs[others[0]])
    same = {k: True for k in libs}
    for k, lib in libs.items():  # warm-up of each library
        _, out = call(lib)
        same[k] = torch.equal(ref.view(torch.int32), out.view(torch.int32))
    order = others + ["this", "this"] + others[::-1]
    ms = {k: [] for k in libs}
    for _ in range(args.rounds):
        for k in order:
            t, out = call(libs[k])
            ms[k].append(t)
            same[k] = same[k] and torch.equal(ref.view(torch.int32), out.view(torch.int32))
    med = {k: statistics.median(v) for k, v in ms.items()}
    base = med[others[0]]
    res = {"card": card_line(), "B": B, "steps": STEPS, "block": F.BLOCK, "rounds": args.rounds,
           "order": order, "ms": ms, "median_ms": med,
           "over_first_other": {k: v / base for k, v in med.items()},
           "ptxas": regs, "sass_instructions": sass, "bit_equal": same}
    print(res["card"])
    for k in libs:
        print(f"K2 {k}: median {med[k]:.4f} ms per call of {STEPS} steps "
              f"({med[k] / base:.4f} of {others[0]}); bit-equal {same[k]}; "
              f"SASS {sass.get(k, 'not dumped')}; {regs[k]}; calls {[round(t, 4) for t in ms[k]]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if not all(same.values()):
        print("ab_k2: the K2 builds disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"total {time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
