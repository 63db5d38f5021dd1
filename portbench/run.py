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
loaded.  A cell on several cards runs one process a card (``ranks.py``);
this process is rank 0 and prints the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
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
    # A rank above 0 of a cell on several cards, started by rank 0 (ranks.py).
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.resolve(args.workload)
    if args.rank is not None:
        from portbench import ranks

        return ranks.follow(cell, args.rank, args.store, args.seed, args.seconds,
                            bool(args.trace), T_START)
    import torch

    marks = {"torch_import": time.perf_counter() - T_START}
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    marks["cuda_probe"] = time.perf_counter() - T_START
    if cell.chips > 1:
        from portbench import ranks

        result, found = ranks.lead(cell, args.seed, args.seconds, bool(args.trace), T_START,
                                   marks)
    else:
        result, _ = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                     torch.device("cuda", 0), T_START, marks)
        found = harness.forbidden_modules()
    return harness.report(result, found)


if __name__ == "__main__":
    sys.exit(main())
