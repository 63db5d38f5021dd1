"""The harness: finds a cell's files by name, runs it, prints its result.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration is the file the ``configs`` entry of its name gives; its
traffic is ``portbench/traffic/<traffic>.json``, whose ``driver`` names the
module ``portbench/drivers/<driver>.py`` that runs it; the limits of its
check are ``portbench/limits/<cell>.json``; each per-layer metric is
``portbench/metrics/<name>.py`` with a function ``read(trace)`` that
returns a number or None.  Adding a configuration, a traffic mix, a cell or
a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "safe_control_gym_tpu")


@dataclasses.dataclass
class Cell:
    """A cell's files, read: what a driver is given."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int
    units: dict
    root: Path = ROOT


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files read."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    cfg_entry = next((c for c in bench["configs"] if c["name"] == w["config"]), None)
    if cfg_entry is None:
        raise KeyError(f"no configuration {w['config']!r} in BENCHMARK.json")
    e2e = [m["name"] for m in bench["end_to_end"] if _in_cell(m, name)]
    layer = [m["name"] for m in bench["per_layer"] if _in_cell(m, name)]
    return Cell(name=name, config=_load(root / cfg_entry["file"]),
                traffic=_load(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
                limits=_load(root / "portbench" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer, chips=int(w["chips"]),
                units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]},
                root=root)


def driver(cell: Cell):
    name = cell.traffic["driver"]
    return _module(cell.root / "portbench" / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def reader(cell: Cell, metric: str):
    path = cell.root / "portbench" / "metrics" / f"{metric}.py"
    return _module(path, "portbench_metric_" + metric.replace(".", "_")).read


def forbidden_modules():
    """Modules loaded whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def p95(values):
    """The 95th percentile of all values (Python's exclusive quantiles)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20)[-1]


LEAD = 3  # units the host may run ahead of the card


def window(job, seconds: float):
    """Dispatch the job's units back to back for ``seconds`` of host time,
    an event on the stream after each.  The host runs at most ``LEAD`` units
    ahead of the card (it waits for the event of the unit ``LEAD`` back,
    never for the stream to drain), so the card keeps work queued and the
    window ends within a few units of ``seconds``.  Returns (window
    seconds, units, each unit's milliseconds from the previous unit's
    completion to its own)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    while True:
        job.unit()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if time.perf_counter() - t0 >= seconds:
            break
        if len(events) > LEAD:
            events[-1 - LEAD].synchronize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, len(events), unit_ms(start, events)


def unit_ms(start, events):
    """Each unit's milliseconds, from the previous unit's event (the first:
    ``start``) to its own."""
    marks = [start] + events
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def traced_window(job, units: int):
    """``units`` units under the profiler; returns the trace."""
    import torch

    from portbench import trace

    with trace.session() as prof:
        with trace.window_span():
            for _ in range(units):
                job.unit()
            torch.cuda.synchronize()
    return trace.read(prof, units, job)


def exact_products() -> None:
    """float32 products in full, as every configuration states: TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def read_end_to_end(cell: Cell, job, wall: float, units: int, unit_ms, setup_s: float) -> dict:
    """The cell's end-to-end metrics of a window."""
    values = job.end_to_end(wall, units, unit_ms)
    values["setup_s"] = setup_s
    return {m: {"value": values[m], "unit": cell.units[m]} for m in cell.end_to_end}


def read_per_layer(cell: Cell, tr) -> dict:
    """The cell's per-layer metrics that its readers find in trace ``tr``."""
    metrics = {}
    for m in cell.per_layer:
        value = reader(cell, m)(tr)
        if value is not None:
            metrics[m] = {"value": value, "unit": cell.units[m]}
    return metrics


def breakdown(tr) -> dict:
    return {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}


def verdict(cell: Cell, numbers: dict):
    """(correct, compared): every limit has its number and none is over it;
    each number beside its limit."""
    lim = cell.limits["limits"]
    correct = set(lim) <= set(numbers) and all(numbers[k] <= lim[k] for k in lim)
    return bool(correct), {k: {"value": numbers[k], "limit": lim.get(k)} for k in numbers}


def device_block(device, count: int, peak: int, **more) -> dict:
    import torch

    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": count,
            "memory_peak_bytes": peak, **more}


def result(correct: bool, attempted: int, metrics: dict, device: dict, phases: dict,
           compared: dict, breakdown=None, **more) -> dict:
    """The result line's object; ``compared`` comes last."""
    res = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        res["breakdown"] = breakdown
    res.update(more)
    res["setup_phases_s"] = phases
    res["compared"] = compared
    return res


def report(res: dict, forbidden) -> int:
    """Prints the run's end and returns its exit code: 3, and no result,
    where a module the run may not load was loaded; else the set-up parts
    and each compared number beside its limit on standard error, then the
    result line."""
    if forbidden:
        print(f"portbench: modules the run may not load were loaded: {forbidden}",
              file=sys.stderr)
        return 3
    print(f"setup phases (s from the start): {res['setup_phases_s']}", file=sys.stderr)
    for k, v in res["compared"].items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(res))
    return 0


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             marks=None):
    """Set up, measure, free, check; returns (result dict, compared numbers).
    ``marks``: seconds from ``t_start`` at the end of the parts of set-up
    made before the call.  On the CPU (the tests) the program runs its
    kernels' plain versions and a few units stand in for the window."""
    import torch

    exact_products()
    # Seconds from the start at the end of each part of set-up.
    phases = dict(marks or {})
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    phases["cuda_context"] = time.perf_counter() - t_start
    job = driver(cell).Job(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    phases["job"] = setup_s
    metrics, more, brk = {}, {}, None
    if traced:
        tr = traced_window(job, int(cell.traffic["trace_units"]))
        metrics = read_per_layer(cell, tr)
        attempted = tr.units
        more = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        brk = breakdown(tr)
    elif device.type == "cuda":
        wall, attempted, times = window(job, seconds)
        metrics = read_end_to_end(cell, job, wall, attempted, times, setup_s)
    else:
        attempted = int(cell.traffic.get("cpu_units", 2))
        for _ in range(attempted):
            job.unit()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    job.free()
    numbers = job.check()
    correct, compared = verdict(cell, numbers)
    return result(correct, attempted, metrics, device_block(device, 1, peak, **more), phases,
                  compared, brk), numbers
