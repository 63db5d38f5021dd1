#!/usr/bin/env python3
"""Split the PPO train steps of a benchmark cell by phase on one card.

Builds a train cell's job as ``portbench/run.py`` does (its driver, its
weights from ``--seed``), then traces ``--units`` train steps four times
in turns, with the program's phase spans (``utils/profiling.py::annotate``)
turned off, on, off, on.  Prints one JSON line and writes it to
``--out/<cell>.json``:

* ``windows``: each traced window's ms a step, device operations a step,
  idle share and idle seconds by label (``Trace.idle_gaps``);
* ``metrics``: every per-layer metric of the cell read from each window;
* ``spans``: for each span of the last window, a step's count, host ms,
  launch calls, and the device operations and ms those calls launched (by
  the profiler's correlation ids), the largest by name
  (``utils/profiling.py::summarize_spans``); ``in_no_leaf``: the step
  span's less its leaves';
* ``span_cost_us``: 10**5 empty spans, microseconds a span with no
  profiler and under a profiler of the host and the card.

    python3 scripts/span_breakdown_port.py --workload quad3d_fig8_ppo.train_b32k
        [--units 10] [--seed 2147484000] [--out results/spans]

Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEP = "scg.ppo.train_step"


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip()


def traced(job, units, spans: bool, export_dir=None):
    """``units`` steps in the benchmark's traced window; the program's spans
    off (each ``annotate`` a no-op) or on.  Returns the Trace."""
    import torch

    from portbench import trace
    from safe_control_gym_torch.controllers import ppo as ppo_module

    saved = ppo_module.annotate
    if not spans:
        ppo_module.annotate = lambda name: contextlib.nullcontext()
    try:
        with trace.session() as prof:
            with trace.window_span():
                for _ in range(units):
                    job.unit()
                torch.cuda.synchronize()
    finally:
        ppo_module.annotate = saved
    tr = trace.read(prof, units, job)
    if export_dir:  # after the read: the export leaves fewer events to read
        os.makedirs(export_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(export_dir, "trace.json"))
    return tr


def window_row(tr):
    gaps = tr.idle_gaps(k=40)
    idle = sum(v for _, v in gaps)
    return {"ms_a_step": 1e3 * tr.window_s / tr.units,
            "device_ops_a_step": len(tr.device_ops) / tr.units,
            "idle_share": 1.0 - tr.busy_s() / tr.window_s, "idle_s": idle,
            "idle_between_operations_share": dict(gaps).get("host: between operations", 0.0)
            / idle if idle else 0.0,
            "idle_gaps": gaps[:12]}


def span_cost(n=100_000):
    """Microseconds a call of an empty span, with no profiler and under one
    of the host and the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from safe_control_gym_torch.utils import profiling

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("scg.bench"):
                pass
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / n

    off = loop()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        on = loop()
    counted = sum(e.count for e in prof.key_averages() if e.key == "scg.bench")
    return {"off": off, "profiler_on": on, "spans_counted": counted}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--units", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2147484000)
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "spans"))
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from safe_control_gym_torch.utils import profiling

    if not torch.cuda.is_available():
        print("span_breakdown_port: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.resolve(args.workload)
    job = harness.driver(cell).Job(cell, args.seed, torch.device("cuda", 0))
    trace_dir = os.path.join(args.out, "trace_" + args.workload)
    shutil.rmtree(trace_dir, ignore_errors=True)
    windows, metrics = [], []
    for i, spans in enumerate((False, True, False, True)):
        tr = traced(job, args.units, spans, trace_dir if i == 3 else None)
        windows.append({"spans": spans, **window_row(tr)})
        metrics.append({m: harness.reader(cell, m)(tr) for m in cell.per_layer})
    rows = {r["name"]: r for r in profiling.summarize_spans(trace_dir, top=6)}
    shutil.rmtree(trace_dir)
    per_step = {"count", "host_ms", "launches", "device_ops", "device_ms"}
    spans = {name: {**{k: r[k] / args.units for k in per_step},
                    "largest": [[n, ms / args.units, c / args.units] for n, ms, c in r["largest"]]}
             for name, r in rows.items()}
    leaves = [v for k, v in spans.items() if k != STEP]
    in_no_leaf = {k: spans[STEP][k] - sum(v[k] for v in leaves) for k in per_step - {"count"}}
    k4_s, k4_n = tr.kernel(*cell.config["program"]["update_kernels"])
    out = {
        "workload": args.workload, "card": card(), "torch": torch.__version__,
        "units": args.units, "seed": args.seed,
        "windows": windows,
        "metrics": metrics,
        "spans": spans,
        "in_no_leaf": in_no_leaf,
        "leaves_over_step_device_ms": sum(v["device_ms"] for v in leaves)
        / spans[STEP]["device_ms"],
        "k4_span_over_k4_kernels": spans["scg.ppo.k4"]["device_ms"] * args.units / (1e3 * k4_s),
        "k4_launches_a_step": k4_n / args.units,
        "span_cost_us": span_cost(),
    }
    job.free()
    os.makedirs(args.out, exist_ok=True)
    line = json.dumps(out)
    with open(os.path.join(args.out, f"{args.workload}.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
