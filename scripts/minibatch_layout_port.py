#!/usr/bin/env python3
"""Time the trainer's minibatch layout on one card at the train cells' shapes.

For each row width (F = 20, the quadrotor's; F = 9, cart-pole's), N =
4,194,304 packed rows and 4 minibatches of 1,048,576 from one permutation:
``fast_update.minibatch_layout`` (one kernel launch) against the two copies
it replaces, the row gather ``packed[idx]`` and the transpose copy
``.transpose(1, 2).contiguous()``, each timed with CUDA events over
``--reps`` calls after a warm-up.  Prints one JSON line and writes it to
``--out``: ms a call (an epoch), the bytes one pass needs (each row read in
whole 32-B sectors, the int64 index read, the output written once) and the
rate those bytes give against 3.35 TB/s.

    python3 scripts/minibatch_layout_port.py [--reps 20] [--out results/layout.json]

Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PEAK_BYTES_S = 3.35e12
SECTOR = 32


def sector_bytes(F: int) -> float:
    """Mean bytes of the 32-B sectors that a row of F floats touches, over
    the row starts of an aligned buffer of such rows."""
    row = 4 * F
    starts = [(k * row) % SECTOR for k in range(SECTOR)]
    return SECTOR * sum((o + row - 1) // SECTOR + 1 for o in starts) / len(starts)


def timed(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="results/layout.json")
    args = ap.parse_args()
    import torch

    from safe_control_gym_torch.parallel import fast_update as fu

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    N, n_mini, m = 4_194_304, 4, 1_048_576
    rows = []
    for F in (20, 9):
        gen = torch.Generator(device=dev).manual_seed(F)
        packed = torch.randn(N, F, generator=gen, device=dev)
        idx = torch.randperm(N, generator=gen, device=dev)[:n_mini * m].view(n_mini, m)
        gathered = packed[idx]
        assert torch.equal(fu.minibatch_layout(packed, idx), fu.minibatch_layout_plain(packed, idx))
        ms = {"kernel": timed(lambda: fu.minibatch_layout(packed, idx), args.reps),
              "gather": timed(lambda: packed[idx], args.reps),
              "transpose": timed(lambda: gathered.transpose(1, 2).contiguous(), args.reps)}
        need = n_mini * m * (sector_bytes(F) + 8 + 4 * F)
        rows.append({"F": F, "ms": ms, "plain_ms": ms["gather"] + ms["transpose"],
                     "bytes": need, "kernel_bytes_per_s": need / (1e-3 * ms["kernel"]),
                     "kernel_roofline_pct": 100.0 * need / PEAK_BYTES_S / (1e-3 * ms["kernel"])})
        del packed, idx, gathered
        torch.cuda.empty_cache()
    out = {"card": card, "torch": torch.__version__, "N": N, "n_mini": n_mini, "m": m,
           "reps": args.reps, "rows": rows}
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
