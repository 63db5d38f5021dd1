"""The port's profiling helpers (``utils/profiling.py``) on the CPU: the twin
of tests/test_build.py::test_profiling_trace_summary (``device_trace`` then
``summarize_kernels`` gives ``[{"name", "total_us", "count"}]``), an
``annotate`` region found in the trace, the summary's choice of device
events over host events and its leaving out the lead spin kernels, and
``ThroughputMeter``.  The card's session (``lead_session``, CUDA activity)
runs in chip_smoke.py's phase_experiment."""

import json
import os

import pytest
import torch

from safe_control_gym_torch.utils import profiling as P


def f(x):
    return torch.sin(x) @ torch.cos(x.T)


def test_profiling_trace_summary(tmp_path):
    x = torch.ones(128, 128)
    f(x)
    with P.device_trace(str(tmp_path)):
        for _ in range(3):
            with P.annotate("scg_region"):
                f(x)
    rows = P.summarize_kernels(str(tmp_path), top=50)
    assert rows and all({"name", "total_us", "count"} <= set(r) for r in rows)
    assert [r["total_us"] for r in rows] == sorted((r["total_us"] for r in rows), reverse=True)
    by_name = {r["name"]: r for r in rows}
    assert by_name["scg_region"]["count"] == 3 and by_name["scg_region"]["total_us"] > 0
    assert by_name["aten::sin"]["count"] == 3
    assert len(P.summarize_kernels(str(tmp_path), top=2)) == 2


def test_summary_takes_device_events_and_the_newest_trace(tmp_path):
    """Where a trace holds device events (kernels, copies, memsets), only
    those count; the spin kernels that open a card session are left out; the
    newest trace of the directory is read."""
    old = {"traceEvents": [{"ph": "X", "name": "old", "cat": "kernel", "dur": 1}]}
    (tmp_path / "a.json").write_text(json.dumps(old))
    events = [
        {"ph": "X", "name": "aten::mm", "cat": "cpu_op", "dur": 50},
        {"ph": "X", "name": "spin_kernel(long)", "cat": "kernel", "dur": 900},
        {"ph": "X", "name": "quad3d_policy_rollout_kernel", "cat": "kernel", "dur": 7},
        {"ph": "X", "name": "ppo_grads_kernel", "cat": "kernel", "dur": 3},
        {"ph": "X", "name": "ppo_grads_kernel", "cat": "kernel", "dur": 3},
        {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy", "dur": 2},
        {"ph": "i", "name": "marker", "cat": "kernel"},
    ]
    new = tmp_path / "b.json"
    new.write_text(json.dumps({"traceEvents": events}))
    os.utime(tmp_path / "a.json", (1, 1))
    assert P.summarize_kernels(str(tmp_path)) == [
        {"name": "quad3d_policy_rollout_kernel", "total_us": 7, "count": 1},
        {"name": "ppo_grads_kernel", "total_us": 6, "count": 2},
        {"name": "Memcpy HtoD", "total_us": 2, "count": 1}]
    with pytest.raises(FileNotFoundError):
        P.summarize_kernels(str(tmp_path / "missing"))


def test_throughput_meter():
    m = P.ThroughputMeter()
    x = torch.ones(64, 64)
    for _ in range(3):
        with m.measure(100, sync_on={"out": [x, x]}):
            f(x)
    assert m.steps == 300 and m.elapsed > 0
    assert m.steps_per_sec == pytest.approx(300 / m.elapsed)
    assert P._cuda_devices({"a": [x, (x,)], "b": 3}) == set()  # nothing to wait for here
