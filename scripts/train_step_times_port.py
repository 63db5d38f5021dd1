#!/usr/bin/env python3
"""Each train step's time in a benchmark cell's window, and where the host
spent it, on one card.

Two parts, one process, one cell (``--workload``, a train cell of
``BENCHMARK.json``) built by ``portbench``'s harness from ``--seed``:

1. isolated steps: ``--isolated`` steps, each after a synchronize, timed on
   the host (the enqueue of the step's launches) and by CUDA events around
   it (the step's device time with the card otherwise idle);
2. the window as the harness runs it (at most ``harness.LEAD`` steps queued
   ahead of the card) for ``--seconds``: each step's time between the CUDA
   events that close it and the step before, and for each step the host ms
   inside the step's call (launches, and the waits of a full launch queue)
   and the host ms waiting on the lead event.  A step more than 3 ms above
   the window's median is listed with its host numbers and the Python
   garbage collections that ran during the window (``gc.callbacks``).

A card-paced window shows lead waits on most steps; a host-paced stretch
shows none, with host ms a step near the step time.  Prints one JSON line
of the summary and writes it, the slow steps and every step's numbers to
``--out``.

    python3 scripts/train_step_times_port.py --workload cartpole_stab_ppo.train_b32k \\
        [--seed 3100000911] [--seconds 40] [--out results/step_times.json]

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SLOW_MS = 3.0  # a step this far above the window's median is listed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3100000911)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--isolated", type=int, default=12)
    ap.add_argument("--out", default="results/step_times.json")
    args = ap.parse_args()
    import torch

    from portbench import harness

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cell = harness.resolve(args.workload)
    job = harness.driver(cell).Job(cell, args.seed, dev)
    for _ in range(3):
        job.unit()
    torch.cuda.synchronize()

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    iso_host, iso_dev = [], []
    for _ in range(args.isolated):
        torch.cuda.synchronize()
        e0, t0 = event(), time.perf_counter()
        job.unit()
        t1, e1 = time.perf_counter(), event()
        torch.cuda.synchronize()
        iso_host.append(1e3 * (t1 - t0))
        iso_dev.append(e0.elapsed_time(e1))

    collections, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            collections.append((started["t"], 1e3 * (time.perf_counter() - started["t"]),
                                info["generation"]))

    gc.callbacks.append(on_gc)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    marks, host, wait, at = [event()], [], [], []
    while True:
        t0 = time.perf_counter()
        job.unit()
        t1 = time.perf_counter()
        marks.append(event())
        host.append(1e3 * (t1 - t0))
        at.append(t1 - t_start)
        w = 0.0
        if len(marks) - 1 > harness.LEAD:
            marks[-1 - harness.LEAD].synchronize()
            w = 1e3 * (time.perf_counter() - t1)
        wait.append(w)
        if time.perf_counter() - t_start >= args.seconds:
            break
    torch.cuda.synchronize()
    gc.callbacks.remove(on_gc)
    job.free()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    med = statistics.median(ms)
    slow = [{"step": i, "ms": ms[i], "host_ms": host[i], "lead_wait_ms": wait[i],
             "at_s": at[i]} for i, m in enumerate(ms) if m > med + SLOW_MS]
    gcs = [{"at_s": s - t_start, "ms": d, "generation": g} for s, d, g in collections
           if s >= t_start]
    summary = {"card": card, "workload": args.workload, "seed": args.seed, "root": ROOT,
               "isolated_host_ms_median": statistics.median(iso_host),
               "isolated_device_ms_median": statistics.median(iso_dev),
               "steps": len(ms), "median_ms": med, "p95_ms": harness.p95(ms), "max_ms": max(ms),
               "host_ms_median": statistics.median(host),
               "lead_wait_ms_median": statistics.median(wait),
               "steps_without_lead_wait": sum(1 for w in wait[harness.LEAD:] if w < 0.05),
               "n_slow": len(slow), "n_gc": len(gcs), "gc_ms_total": sum(g["ms"] for g in gcs)}
    line = json.dumps(summary)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
        f.write(json.dumps({"slow": slow, "gc": [g for g in gcs if g["ms"] > 1.0],
                            "isolated_host_ms": iso_host, "isolated_device_ms": iso_dev}) + "\n")
        f.write(json.dumps({"ms": ms, "host_ms": host, "lead_wait_ms": wait}) + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
