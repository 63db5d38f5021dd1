"""Run one cell of the benchmark of ``safe_control_gym_torch`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets the cell up from the seed (that time is ``setup_s``), measures for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or traces the
traffic's ``trace_units`` units (``--trace 1``: its per-layer metrics), then
frees the program's state and checks what the timed path produced against
the plain reference.  Prints each compared number beside its limit as the
last lines of standard error, and one JSON line as the last line of
standard output.  Exits non-zero, printing no result, without a CUDA card
or with fewer cards than the cell asks for, or where a JAX module was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
# Libraries that probe for JAX or Flax at import (transformers) leave them out.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.resolve(args.workload)
    import torch

    marks = {"torch_import": time.perf_counter() - T_START}
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    marks["cuda_probe"] = time.perf_counter() - T_START
    result, _ = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                                 marks)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules the run may not load were loaded: {found}", file=sys.stderr)
        return 3
    print(f"setup phases (s from the start): {result['setup_phases_s']}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
