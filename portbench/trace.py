"""The traced window: a ``torch.profiler`` session and what is read from it.

The session records the host's operations and the card's (kernels, copies,
memsets).  It opens as an empty session, then a session that starts with
short spin kernels and a synchronize: the profiler was seen to drop the
first events of a session in a process that had launched much before it,
and a session that opens so recorded every kernel.  The window is the host
span named :data:`WINDOW`; the card is busy where any of its operations
runs inside it.  Readers of per-layer metrics get a :class:`Trace`.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "portbench.window"
LEAD_KERNELS, LEAD_CYCLES = 256, 2000
LEAD_NAME = "spin_kernel"
_BACK_SCAN = 4096  # host operations looked back through for the one open at a gap


@dataclasses.dataclass
class Trace:
    """What a per-layer reader reads: the card's operations inside the
    window as ``(name, start_ns, end_ns)``, the window's bounds, the units
    (train steps or calls) it holds, and the job that ran them."""

    device_ops: list
    host_ops: list
    start_ns: int
    end_ns: int
    units: int
    job: object

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def busy_s(self) -> float:
        """Seconds inside the window in which the card ran an operation."""
        busy, cur_s, cur_e = 0, None, None
        for s, e in sorted((max(s, self.start_ns), min(e, self.end_ns))
                           for _, s, e in self.device_ops):
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy * 1e-9

    def kernel(self, *names):
        """(device seconds, launches) of the operations whose name holds any
        of ``names``."""
        hits = [(e - s) for n, s, e in self.device_ops if any(k in n for k in names)]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, k: int = 10):
        tot = collections.Counter()
        for n, s, e in self.device_ops:
            tot[n] += (e - s) * 1e-9
        return [[n, v] for n, v in tot.most_common(k)]

    def idle_gaps(self, k: int = 10):
        """The card's idle time inside the window, by the innermost host
        operation open at each gap's middle."""
        spans = sorted((s, e) for _, s, e in self.device_ops)
        gaps, t = [], self.start_ns
        for s, e in spans:
            if s > t:
                gaps.append((t, min(s, self.end_ns)))
            t = max(t, e)
        if t < self.end_ns:
            gaps.append((t, self.end_ns))
        tot = collections.Counter()
        # By start, the enclosing operation before those it encloses.
        hosts = sorted((s, -e, n) for n, s, e in self.host_ops if n != WINDOW)
        hosts = [(s, -ne, n) for s, ne, n in hosts]
        starts = [h[0] for h in hosts]
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            mid = (g0 + g1) // 2
            label = "host: between operations"
            i = bisect.bisect_right(starts, mid)
            for s, e, n in reversed(hosts[max(0, i - _BACK_SCAN):i]):
                if e >= mid:
                    label = n
                    break
            tot[label] += (g1 - g0) * 1e-9
        return [[n, v] for n, v in tot.most_common(k)]


@contextlib.contextmanager
def session():
    """A profiler session on the card that records what the block launches."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        yield prof


def read(prof, units: int, job) -> Trace:
    """The :class:`Trace` of a finished session whose window ran ``units``."""
    from torch.autograd import DeviceType

    dev, host, win = [], [], None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # The window's span shows on the device's timeline too, as an
            # annotation; it is no operation of the card.
            if LEAD_NAME not in e.name() and e.name() != WINDOW:
                dev.append((e.name(), s, s + d))
        elif e.name() == WINDOW:
            win = (s, s + d)
        else:
            host.append((e.name(), s, s + d))
    if win is None:
        raise RuntimeError("the profiler recorded no window span")
    dev = [d for d in dev if win[0] <= d[1] < win[1]]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation inside the window")
    return Trace(dev, host, win[0], win[1], units, job)


def window_span():
    return record_function(WINDOW)
