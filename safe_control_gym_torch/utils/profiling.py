"""Profiling and tracing.

Port of ``safe_control_gym_tpu/utils/profiling.py`` on ``torch.profiler``
(the reference has no tracer, only wall-clock printouts): ``device_trace``
writes a Chrome trace of a block, ``summarize_kernels`` sums its device
time by kernel, ``annotate`` is the program's span, ``summarize_spans``
splits a trace by span, and ``ThroughputMeter`` measures env-steps/s over
timed blocks.

Spans.  The trainer names its phases with ``annotate`` (``scg.ppo.*``:
the train step, collect, GAE, the batch layout, K4, the optimizer).  Wrap a
run in ``device_trace(dir)`` and the phases show in Perfetto as host
operations on the same clock as the kernels; ``summarize_spans(dir)`` then
gives each phase's host milliseconds, launch calls, and the device
operations and milliseconds those calls launched::

    with device_trace("/tmp/trace"):
        ppo.state, _ = ppo._train_step(ppo.state)
    for row in summarize_spans("/tmp/trace"):
        print(row)

A span costs one flag read when no profiler runs, and under a profiler one
host record (a few microseconds); it puts nothing on the card.  Its device
time is read from the trace afterwards, never timed while the program runs.

On a card every session opens as ``lead_session`` does: the profiler was
seen to drop the first events of a session in a process that had launched
much before it (the policy kernel and the first small kernels of a PPO
train step among them), and a session that opens after an empty one with
``PROFILE_LEAD_KERNELS`` short spin kernels (``torch.cuda._sleep``, left
out of every summary) recorded every kernel.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import gzip
import json
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

PROFILE_LEAD_KERNELS, PROFILE_LEAD_CYCLES = 256, 2000
LEAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
# Chrome-trace categories of the work a card ran: kernels, copies, memsets.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Host calls that put work on a card, by name prefix.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
SPAN_PREFIX = "scg."  # the program's spans


@contextlib.contextmanager
def lead_session(activities, empty_first: bool = True, **kwargs):
    """A ``torch.profiler.profile`` session on the card that records what
    the block launches: an empty session first (``empty_first``), then the
    session, opened with the spin kernels and a synchronize.  Yields the
    profiler; the block should synchronize before it ends."""
    if empty_first:
        with profile(activities=activities):
            torch.cuda.synchronize()
    with profile(activities=activities, **kwargs) as prof:
        for _ in range(PROFILE_LEAD_KERNELS):
            torch.cuda._sleep(PROFILE_LEAD_CYCLES)
        torch.cuda.synchronize()
        yield prof


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace a block into ``log_dir`` (a Chrome trace JSON that Perfetto
    and ``summarize_kernels`` read): ``with device_trace('/tmp/trace'):``.
    With a card the CUDA activity is recorded beside the host's, and the
    block is synchronized before the session ends; without one, the
    host's."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    if cuda:
        session = lead_session([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    else:
        session = profile(activities=[ProfilerActivity.CPU])
    with session as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


class ThroughputMeter:
    """Env-steps/s over timed blocks; each block's end waits for the cards
    its ``sync_on`` tensors live on (nothing to wait for on the CPU)."""

    def __init__(self):
        self.steps = 0
        self.elapsed = 0.0

    @contextlib.contextmanager
    def measure(self, num_steps: int, sync_on):
        t0 = time.perf_counter()
        yield
        for dev in _cuda_devices(sync_on):
            torch.cuda.synchronize(dev)
        self.elapsed += time.perf_counter() - t0
        self.steps += num_steps

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-12)


def _cuda_devices(tree):
    """The CUDA devices of the tensors in a tensor, list, tuple or dict."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """The program's span ``with annotate(name):``.  With no profiler
    running it is one shared no-op context; under one it is a host
    operation named ``name`` (``_RecordFunctionFast``: a ``cpu_op`` on the
    profiler's clock, never a user annotation, so nothing of it lands on
    the device's timeline)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def _trace_events(trace_dir: str):
    """The complete events of the newest ``device_trace`` in ``trace_dir``."""
    files = glob.glob(os.path.join(trace_dir, "*.json")) + glob.glob(
        os.path.join(trace_dir, "*.json.gz"))
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    path = max(files, key=os.path.getmtime)
    with (gzip.open(path) if path.endswith(".gz") else open(path)) as f:
        return [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]


def summarize_spans(trace_dir: str, top: int = 3):
    """The newest ``device_trace`` of ``trace_dir`` split by the program's
    spans (names that start with :data:`SPAN_PREFIX`):
    ``[{"name", "count", "host_ms", "launches", "device_ops", "device_ms",
    "largest"}, ...]`` in the order the spans first opened.  ``host_ms``
    sums the spans' host durations; ``launches`` counts the host's launch
    calls (:data:`LAUNCH_CALLS`) that start inside them, a span's nested
    spans included; ``device_ops`` and ``device_ms`` count and sum the
    device's operations those calls launched (matched by the profiler's
    correlation ids, the lead spin kernels left out), and ``largest`` lists
    the ``top`` of them by name as ``[name, ms, count]``."""
    events = _trace_events(trace_dir)
    spans = sorted((e for e in events
                    if e.get("cat") == "cpu_op" and e["name"].startswith(SPAN_PREFIX)),
                   key=lambda e: e["ts"])
    ran = collections.defaultdict(list)  # correlation id -> [(name, us)] of the device
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATEGORIES and LEAD_KERNEL not in e["name"] and corr is not None:
            ran[corr].append((e["name"], e.get("dur", 0)))
    launches = sorted(((e["ts"], ran.get(e.get("args", {}).get("correlation"), []))
                       for e in events if e["name"].startswith(LAUNCH_CALLS)),
                      key=lambda launch: launch[0])
    starts = [ts for ts, _ in launches]
    rows = {}
    by_op = collections.defaultdict(collections.Counter)  # span -> device op -> us
    n_op = collections.defaultdict(collections.Counter)  # span -> device op -> count
    for e in spans:
        row = rows.setdefault(e["name"], {"name": e["name"], "count": 0, "host_ms": 0.0,
                                          "launches": 0, "device_ops": 0, "device_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += e.get("dur", 0) * 1e-3
        i0 = bisect.bisect_left(starts, e["ts"])
        i1 = bisect.bisect_right(starts, e["ts"] + e.get("dur", 0))
        row["launches"] += i1 - i0
        for _, ops in launches[i0:i1]:
            for name, us in ops:
                row["device_ops"] += 1
                row["device_ms"] += us * 1e-3
                by_op[e["name"]][name] += us
                n_op[e["name"]][name] += 1
    for name, row in rows.items():
        row["largest"] = [[n, us * 1e-3, n_op[name][n]] for n, us in by_op[name].most_common(top)]
    return list(rows.values())


def summarize_kernels(trace_dir: str, top: int = 20):
    """Device time by kernel in the newest ``device_trace`` of ``trace_dir``:
    ``[{"name", "total_us", "count"}, ...]``, the largest total first.
    Counts the device's events (kernels, copies, memsets) where the trace
    holds any, else every complete event (a trace of the host alone); the
    lead spin kernels are left out."""
    events = _trace_events(trace_dir)
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    dur, cnt = collections.Counter(), collections.Counter()
    for e in dev or events:
        if LEAD_KERNEL not in e["name"]:
            dur[e["name"]] += e.get("dur", 0)
            cnt[e["name"]] += 1
    return [{"name": n, "total_us": d, "count": cnt[n]} for n, d in dur.most_common(top)]
