"""Cells on several cards: one process a card.

For a cell whose ``chips`` is above 1, the process the benchmark was
started as is rank 0, on ``cuda:0``.  It starts ``chips - 1`` more
processes of its own script (``run.py`` or ``calibrate.py``, with the same
arguments and ``--rank r --store <file>``); rank r calls
``torch.cuda.set_device(r)`` and uses ``cuda:r``.  The ranks meet through a
``FileStore`` in a fresh temporary directory and join one process group
(NCCL on cards; gloo on the CPU, in the tests) before the driver's ``Job``
is built, so a driver reads its rank, world size and group from
``torch.distributed`` and gets its own card as ``device``.

Rank 0 watches the others: where one exits with an error, or a part of the
run outlives its deadline, it kills every rank, waits for each, and exits
with code 1 and no result.  A rank whose parent has gone exits at once.
With ``chips == 1`` nothing here runs.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from pathlib import Path

from portbench import harness

END = "window_end"  # the store's key of the window's unit count, set by rank 0
SETUP_S = 1140.0  # from the group's start to every Job built: a first run in a checkout compiles
WINDOW_SLACK_S = 120.0  # past --seconds, for the window's last units
TRACE_S = 300.0  # the traced window and the reading of its trace
CHECK_S = 300.0  # free, check, and the ranks' exit
CALIBRATE_SEED_S = 1800.0  # one seed of calibrate.py: Job, units, check, control and faults
STORE_TIMEOUT_S = 3600.0  # the store's own waits; the deadlines above come first
POLL_S = 0.1


class Group:
    """This process's place among a cell's ``world`` ranks: the store, the
    process group and the card; on rank 0 also the other ranks' processes
    and the watch that stops them all.  Use as a context manager: leaving
    it ends the group, and on rank 0 waits for the other ranks to exit."""

    def __init__(self, world: int, rank=None, store_path=None, script: Path = None, argv=(),
                 device_type: str = "cuda"):
        """Rank 0 (``rank`` None) makes the store and starts ``script`` with
        ``argv`` for each other rank; rank r > 0 opens ``store_path``."""
        import torch.distributed as dist

        self.world, self.procs, self.tmp = world, [], None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._deadline, self._what = time.monotonic() + SETUP_S, "set-up"
        if rank is None:
            self.rank = 0
            self.tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
            store_path = os.path.join(self.tmp, "store")
            self.store = dist.FileStore(store_path, world)
            self.store.set_timeout(timedelta(seconds=STORE_TIMEOUT_S))
            self.store.set("plan", json.dumps({"device": device_type}))
            try:
                for r in range(1, world):
                    # A rank's standard output goes to standard error: the
                    # result is the last line of rank 0's standard output.
                    self.procs.append(subprocess.Popen(
                        [sys.executable, str(script), *argv, "--rank", str(r), "--store",
                         store_path], stdout=sys.stderr.fileno()))
            except BaseException:
                self._end_all()
                raise
            target = self._watch_ranks
        else:
            self.rank = int(rank)
            self.store = dist.FileStore(store_path, world)
            self.store.set_timeout(timedelta(seconds=STORE_TIMEOUT_S))
            device_type = json.loads(self.store.get("plan"))["device"]
            self._parent = os.getppid()
            target = self._watch_parent
        self._watch = threading.Thread(target=target, daemon=True)
        self._watch.start()
        try:
            self.device = self._join(device_type)
        except BaseException:
            self.__exit__(*sys.exc_info())
            raise

    def _join(self, device_type: str):
        import torch
        import torch.distributed as dist

        if device_type == "cuda":
            torch.cuda.set_device(self.rank)
            device = torch.device("cuda", self.rank)
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
            backend, extra = "nccl", {"device_id": device}
            # Every rank is on this machine.
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        else:
            device, backend, extra = torch.device("cpu"), "gloo", {}
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, store=dist.PrefixStore("group", self.store),
                                rank=self.rank, world_size=self.world,
                                timeout=timedelta(seconds=STORE_TIMEOUT_S), **extra)
        return device

    # -- the watches -------------------------------------------------------

    def arm(self, seconds: float, what: str) -> None:
        """Rank 0 stops every rank if ``what`` is not done ``seconds`` from now."""
        with self._lock:
            self._deadline, self._what = time.monotonic() + seconds, what

    def _watch_ranks(self):
        while not self._stop.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0):
                    self._abort(f"rank {r} exited with code {p.returncode}")
            with self._lock:
                late = time.monotonic() > self._deadline
                what = self._what
            if late:
                self._abort(f"{what} outlived its deadline")

    def _watch_parent(self):
        while not self._stop.wait(POLL_S):
            if os.getppid() != self._parent:
                os._exit(1)

    def _abort(self, why: str):
        print(f"portbench: {why}; stopping all {self.world} ranks", file=sys.stderr, flush=True)
        self._end_all()
        os._exit(1)

    def _end_all(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)

    # -- exchange through the store ---------------------------------------

    def barrier(self, tag: str) -> None:
        """Waits until every rank has reached ``tag``: on the host, nothing on
        the card."""
        self.store.set(f"{tag}/{self.rank}", "1")
        self.store.wait([f"{tag}/{r}" for r in range(self.world)])

    def gather(self, tag: str, obj):
        """Every rank's ``obj`` (JSON) in rank order on rank 0; None elsewhere."""
        self.store.set(f"{tag}/{self.rank}", json.dumps(obj))
        if self.rank:
            return None
        keys = [f"{tag}/{r}" for r in range(self.world)]
        self.store.wait(keys)
        return [json.loads(self.store.get(k)) for k in keys]

    # -- lifetime ----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        import torch.distributed as dist

        if kind is not None:
            if self.rank == 0:
                self._stop.set()
                self._end_all()
            return False
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.rank == 0:
            self.arm(CHECK_S, "the ranks' exit")
            while any(p.poll() is None for p in self.procs):
                time.sleep(POLL_S)  # the watch stops all at the deadline or a failure
            self._stop.set()
            self._watch.join()
            bad = [(r, p.returncode) for r, p in enumerate(self.procs, 1) if p.returncode]
            self._end_all()
            if bad:
                raise RuntimeError(f"ranks exited with errors: {bad}")
        else:
            self._stop.set()
        return False


class _HostEvent:
    """A timing event on the host clock, where the ranks run on the CPU (the
    tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


def window(job, seconds: float, group: Group):
    """:func:`harness.window` on every rank of ``group``, each on its own
    card, with the end set through the store.  Every rank runs the same
    number of units: rank 0 decides on its host clock when the window ends
    and sets, in the store, the count of units every rank runs.  A rank's
    host runs at most ``LEAD`` + 1 units ahead of rank 0's, since a unit's
    collectives tie the cards together, so rank 0 sets its own count at
    that moment plus ``LEAD`` + 1.  The other ranks look in the store once a
    unit, on the host; nothing more runs on the card than in
    :func:`harness.window`.  Returns (window seconds, units, each unit's
    milliseconds)."""
    import torch

    cuda = group.device.type == "cuda"
    event = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else _HostEvent
    lead = harness.LEAD
    start, events, end = event(), [], None
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    while True:
        job.unit()
        ev = event()
        ev.record()
        events.append(ev)
        n = len(events)
        if end is None:
            if group.rank == 0:
                if time.perf_counter() - t0 >= seconds:
                    end = n + lead + 1
                    group.store.set(END, str(end))
            elif group.store.check([END]):
                end = int(group.store.get(END))
        if end is not None and n >= end:
            if n > end:
                raise RuntimeError(f"rank {group.rank} ran {n} units, past the window's "
                                   f"{end}: its units tie no collective to rank 0")
            break
        if n > lead:
            events[-1 - lead].synchronize()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, len(events), harness.unit_ms(start, events)


def merge(numbers_by_rank):
    """The worst (largest) reading of each key over the ranks that report
    it; a NaN anywhere stays NaN."""
    out = {}
    for numbers in numbers_by_rank:
        for k, v in numbers.items():
            a = out.get(k, v)
            out[k] = float("nan") if a != a or v != v else max(a, v)
    return out


def plain(numbers: dict) -> dict:
    """A check's numbers as JSON holds them."""
    return {k: v if isinstance(v, int) else float(v) for k, v in numbers.items()}


def _peak(device) -> int:
    """The card's peak of allocated bytes; on the CPU (the tests) the
    process's largest resident size."""
    import torch

    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_rank(cell, group: Group, seed: int, seconds: float, traced: bool, t_start: float,
             phases: dict):
    """One rank's run, with :func:`harness.run_cell`'s parts; on rank 0
    returns the result and the modules the run may not load, by rank that
    loaded them (None elsewhere)."""
    import torch

    harness.exact_products()
    phases["group"] = time.perf_counter() - t_start
    job = harness.driver(cell).Job(cell, seed, group.device)
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    phases["job"] = time.perf_counter() - t_start
    group.barrier("ready")
    setup_s = time.perf_counter() - t_start
    phases["all_ranks_ready"] = setup_s
    own, metrics, brk = {}, {}, None
    if traced:
        group.arm(TRACE_S, "the traced window")
        tr = harness.traced_window(job, int(cell.traffic["trace_units"]))
        own.update(units=tr.units, busy_s=tr.busy_s(), window_s=tr.window_s)
        if group.rank == 0:
            metrics, brk = harness.read_per_layer(cell, tr), harness.breakdown(tr)
    else:
        group.arm(seconds + WINDOW_SLACK_S, "the window")
        wall, own["units"], unit_ms = window(job, seconds, group)
        if group.rank == 0:
            metrics = harness.read_end_to_end(cell, job, wall, own["units"], unit_ms, setup_s)
    own["peak"] = _peak(group.device)
    group.arm(CHECK_S, "the check")
    job.free()
    own["numbers"] = plain(job.check())
    own["forbidden"] = harness.forbidden_modules()
    runs = group.gather("result", own)
    if group.rank:
        return None, None
    units = [r["units"] for r in runs]
    if len(set(units)) != 1:
        raise RuntimeError(f"the ranks ran different numbers of units: {units}")
    peaks = [r["peak"] for r in runs]
    more = {"memory_peak_bytes_by_rank": peaks}
    if traced:
        # Rank 0's, as the readers'; every rank's beside it.
        more.update(busy_s=runs[0]["busy_s"], window_s=runs[0]["window_s"],
                    busy_s_by_rank=[r["busy_s"] for r in runs],
                    window_s_by_rank=[r["window_s"] for r in runs])
    correct, compared = harness.verdict(cell, merge(r["numbers"] for r in runs))
    res = harness.result(correct, units[0], metrics,
                         harness.device_block(group.device, group.world, max(peaks), **more),
                         phases, compared, brk, attempted_by_rank=units)
    return res, {r: run["forbidden"] for r, run in enumerate(runs) if run["forbidden"]}


def lead(cell, seed: int, seconds: float, traced: bool, t_start: float, marks: dict,
         device_type: str = "cuda"):
    """Rank 0 of ``run.py`` for a cell on ``cell.chips`` cards: starts the
    other ranks and runs its own; returns the result and the modules the
    run may not load, by rank, for :func:`harness.report`.
    ``device_type="cpu"`` (the tests) runs every rank on the CPU in a gloo
    group."""
    argv = ["--workload", cell.name, "--seed", str(seed), "--seconds", repr(seconds),
            "--trace", str(int(traced))]
    phases = dict(marks)
    with Group(cell.chips, script=harness.PKG / "run.py", argv=argv,
               device_type=device_type) as group:
        result, forbidden = run_rank(cell, group, seed, seconds, traced, t_start, phases)
    own = harness.forbidden_modules()  # rank 0's, once its window and check are over
    if own:
        forbidden[0] = own
    return result, forbidden


def follow(cell, rank: int, store: str, seed: int, seconds: float, traced: bool,
           t_start: float) -> int:
    """Rank ``rank`` (above 0) of ``run.py``: joins rank 0's group, runs its
    part and exits 0; rank 0 reports.  On an error it prints the traceback
    and exits 1 at once, without waiting for the group to end."""
    try:
        with Group(cell.chips, rank=rank, store_path=store) as group:
            run_rank(cell, group, seed, seconds, traced, t_start, {})
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    return 0
