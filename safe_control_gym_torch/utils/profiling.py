"""Profiling and tracing.

Port of ``safe_control_gym_tpu/utils/profiling.py`` on ``torch.profiler``
(the reference has no tracer, only wall-clock printouts): ``device_trace``
writes a Chrome trace of a block, ``summarize_kernels`` sums its device
time by kernel, ``annotate`` names a region in it, and ``ThroughputMeter``
measures env-steps/s over timed blocks.

On a card every session opens as ``lead_session`` does: the profiler was
seen to drop the first events of a session in a process that had launched
much before it (the policy kernel and the first small kernels of a PPO
train step among them), and a session that opens after an empty one with
``PROFILE_LEAD_KERNELS`` short spin kernels (``torch.cuda._sleep``, left
out of every summary) recorded every kernel.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PROFILE_LEAD_KERNELS, PROFILE_LEAD_CYCLES = 256, 2000
LEAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
# Chrome-trace categories of the work a card ran: kernels, copies, memsets.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


def annotate(name: str):
    """A named region in the trace (``torch.profiler.record_function``)."""
    return record_function(name)


def summarize_kernels(trace_dir: str, top: int = 20):
    """Device time by kernel in the newest ``device_trace`` of ``trace_dir``:
    ``[{"name", "total_us", "count"}, ...]``, the largest total first.
    Counts the device's events (kernels, copies, memsets) where the trace
    holds any, else every complete event (a trace of the host alone); the
    lead spin kernels are left out."""
    files = glob.glob(os.path.join(trace_dir, "*.json")) + glob.glob(
        os.path.join(trace_dir, "*.json.gz"))
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    path = max(files, key=os.path.getmtime)
    with (gzip.open(path) if path.endswith(".gz") else open(path)) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    dur, cnt = collections.Counter(), collections.Counter()
    for e in dev or events:
        if LEAD_KERNEL not in e["name"]:
            dur[e["name"]] += e.get("dur", 0)
            cnt[e["name"]] += 1
    return [{"name": n, "total_us": d, "count": cnt[n]} for n, d in dur.most_common(top)]
