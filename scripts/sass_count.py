#!/usr/bin/env python3
"""SASS instruction counts of kernel instances, in this tree and others.

Builds one kernel's CUDA source of each tree as ``scripts/ab_kernel.py``
does (``kernels.NVCC_FLAGS``, all trees in parallel) and counts the SASS
instructions, convergence regions (``BSSY``) and loops of each named
instance (``ab_kernel.sass_count``).  An instance is named by the mangled
template arguments that follow the kernel's name, a comma-separated list
tried in order, so that trees whose templates take other arguments match
too: e.g. K3's observation instance is ``ILi0ELi8ELb1ELb0E`` in a tree with
the maze instances and ``ILi0ELi8ELb1EE`` before them.

    python3 scripts/sass_count.py --kernel k3 \\
        --other parent=results/parent/safe_control_gym_torch/csrc \\
        --instance config4=ILi64ELi8ELb0ELb0E,ILi64ELi8ELb0EE \\
        --instance obs=ILi0ELi8ELb1ELb0E,ILi0ELi8ELb1EE [--out FILE]

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def main():
    import ab_kernel as A

    from safe_control_gym_torch import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(A.KERNELS), default="k3")
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="csrc directory of another tree, under a name")
    ap.add_argument("--instance", action="append", required=True, metavar="NAME=ARGS[,ARGS]",
                    help="an instance by its mangled template arguments, tried in order")
    ap.add_argument("--out", help="also write the counts here as JSON")
    args = ap.parse_args()

    _, _, kname = A.KERNELS[args.kernel]
    trees = {"this": str(kernels.CSRC)}
    trees.update({n: os.path.abspath(d) for n, d in (o.split("=", 1) for o in args.other)})
    out_dir = kernels.BUILD / "sass_count"
    built = A.build_others(args.kernel, trees, out_dir)
    counts = {}
    for tree, (_, path, _) in built.items():
        for spec in args.instance:
            name, prefs = spec.split("=", 1)
            counts.setdefault(name, {})[tree] = A.sass_count(
                path, kname, prefs.split(","), out_dir / f"{tree}_{name}.sass")
    for name, by_tree in counts.items():
        for tree, c in by_tree.items():
            print(f"{name} [{tree}]: {c['instructions']} instructions, {c['bssy']} BSSY, "
                  f"instance {c['instance']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(counts, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
