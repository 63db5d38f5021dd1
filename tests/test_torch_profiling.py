"""The port's profiling helpers (``utils/profiling.py``) on the CPU: the twin
of tests/test_build.py::test_profiling_trace_summary (``device_trace`` then
``summarize_kernels`` gives ``[{"name", "total_us", "count"}]``), an
``annotate`` span found in the trace, the summary's choice of device
events over host events and its leaving out the lead spin kernels,
``ThroughputMeter``, and the spans: no-ops without a profiler, host
operations (not user annotations) under one, nested, split by
``summarize_spans`` (launch calls, and device operations by correlation
id, on synthetic traces), and a PPO train step's phases: their counts, the
operations each encloses, and parameters the spans leave bit for bit as
they were.  The card's session (``lead_session``, CUDA activity) runs in
chip_smoke.py's phase_experiment; the spans in the benchmark's traced
window on the card in portbench/tests/test_portbench_spans.py."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from safe_control_gym_torch.controllers.ppo import PPO
from safe_control_gym_torch.envs import quadrotor as tq
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


def _events(prof, tmp_path, *names):
    """The exported trace's events of each name in ``names``."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [[e for e in events if e.get("name") == n] for n in names]


def test_span_is_a_shared_no_op_without_a_profiler():
    span = P.annotate("scg.test.a")
    assert span is P.annotate("scg.test.b") is P._NO_SPAN
    with span:
        with P.annotate("scg.test.c"):
            pass


def test_span_is_a_host_operation_under_the_profiler(tmp_path):
    """A ``cpu_op`` event on the profiler's clock, never a user annotation
    (which the profiler would mirror onto the device's timeline)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.annotate("scg.test.span"):
            torch.ones(8).sum()
    (events,) = _events(prof, tmp_path, "scg.test.span")
    assert [e["cat"] for e in events] == ["cpu_op"]


def test_spans_nest(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with P.annotate("scg.test.outer"):
                torch.ones(8).sum()
                with P.annotate("scg.test.inner"):
                    torch.ones(8).sum()
    outer, inner = _events(prof, tmp_path, "scg.test.outer", "scg.test.inner")
    assert len(outer) == len(inner) == 2
    for o, i in zip(sorted(outer, key=lambda e: e["ts"]), sorted(inner, key=lambda e: e["ts"])):
        assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summarize_spans_counts_launches_inside_each_span(tmp_path):
    """On a synthetic trace: each span's count, host ms and the launch calls
    that start inside it (nested spans' included); other spans and other
    host calls are not counted."""
    events = [
        _ev("scg.ppo.train_step", "cpu_op", 0, 1000),
        _ev("scg.ppo.gae", "cpu_op", 100, 200),
        _ev("cudaLaunchKernel", "cuda_runtime", 150, 5),
        _ev("cudaLaunchKernelExC", "cuda_runtime", 250, 5),
        _ev("scg.ppo.k4", "cpu_op", 400, 300),
        _ev("cuLaunchKernel", "cuda_driver", 500, 5),
        _ev("cudaMemcpyAsync", "cuda_runtime", 600, 5),
        _ev("cudaMemsetAsync", "cuda_runtime", 650, 5),
        _ev("cudaEventRecord", "cuda_runtime", 660, 5),
        _ev("scg.ppo.k4", "cpu_op", 1100, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 1150, 5),
        _ev("cudaLaunchKernel", "cuda_runtime", 800, 5),  # in the step, in no leaf
        _ev("cudaLaunchKernel", "cuda_runtime", 2000, 5),  # in no span
        _ev("other.region", "cpu_op", 0, 3000),
        {"ph": "i", "name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 120},
    ]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    rows = {r["name"]: r for r in P.summarize_spans(str(tmp_path))}
    assert list(rows) == ["scg.ppo.train_step", "scg.ppo.gae", "scg.ppo.k4"]
    assert rows["scg.ppo.train_step"] == {"name": "scg.ppo.train_step", "count": 1,
                                          "host_ms": 1.0, "launches": 6, "device_ops": 0,
                                          "device_ms": 0.0, "largest": []}
    assert rows["scg.ppo.gae"]["launches"] == 2
    assert rows["scg.ppo.k4"]["count"] == 2 and rows["scg.ppo.k4"]["launches"] == 4
    assert rows["scg.ppo.k4"]["host_ms"] == pytest.approx(0.4)


def test_summarize_spans_takes_device_operations_by_correlation(tmp_path):
    """A device operation counts in every span that encloses the launch call
    with its correlation id, whenever it ran on the card (here long after
    the span closed); operations launched outside every span, those with
    no correlation id, and the lead spin kernels count nowhere."""
    events = [
        _ev("scg.ppo.train_step", "cpu_op", 0, 1000),
        _ev("scg.ppo.gather", "cpu_op", 100, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 120, 5, corr=1),
        _ev("cudaMemcpyAsync", "cuda_runtime", 150, 5, corr=2),
        _ev("scg.ppo.k4", "cpu_op", 300, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 310, 5, corr=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 320, 5, corr=4),
        _ev("scg.ppo.k4", "cpu_op", 500, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 510, 5, corr=5),
        _ev("cudaLaunchKernel", "cuda_runtime", 700, 5, corr=6),  # in the step, in no leaf
        _ev("cudaLaunchKernel", "cuda_runtime", 2000, 5, corr=7),  # in no span
        _ev("cudaLaunchKernel", "cuda_runtime", 530, 5, corr=8),  # a lead spin kernel
        _ev("gather_kernel", "kernel", 5000, 400, corr=1),
        _ev("Memcpy DtoH", "gpu_memcpy", 5400, 100, corr=2),
        _ev("ppo_grads_kernel", "kernel", 5500, 2000, corr=3),
        _ev("reduce_kernel", "kernel", 7500, 50, corr=4),
        _ev("ppo_grads_kernel", "kernel", 7550, 3000, corr=5),
        _ev("mean_kernel", "kernel", 10550, 10, corr=6),
        _ev("other_kernel", "kernel", 10560, 700, corr=7),
        _ev(P.LEAD_KERNEL, "kernel", 10560, 900, corr=8),
        _ev("stray_kernel", "kernel", 11000, 50),  # no correlation id: no launch of a span
    ]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    rows = {r["name"]: r for r in P.summarize_spans(str(tmp_path), top=2)}
    step, gather, k4 = (rows[f"scg.ppo.{n}"] for n in ("train_step", "gather", "k4"))
    assert (step["launches"], step["device_ops"]) == (7, 6)
    assert step["device_ms"] == pytest.approx(5.56)
    assert (gather["device_ops"], gather["device_ms"]) == (2, pytest.approx(0.5))
    assert (k4["count"], k4["launches"], k4["device_ops"]) == (2, 4, 3)
    assert k4["device_ms"] == pytest.approx(5.05)
    assert k4["largest"] == [["ppo_grads_kernel", pytest.approx(5.0), 2],
                             ["reduce_kernel", pytest.approx(0.05), 1]]


# Operations each leaf span must enclose (innermost span), and those it
# alone may enclose within the step: what the phase table of PERF.md §5
# reads as each phase rests on these boundaries in controllers/ppo.py.
SPAN_HOLDS = {"scg.ppo.collect": "aten::tanh", "scg.ppo.pack": "aten::cat",
              "scg.ppo.transpose": "aten::contiguous"}
SPAN_ALONE_HOLDS = {"scg.ppo.gae": "aten::std", "scg.ppo.shuffle": "aten::randperm",
                    "scg.ppo.gather": "aten::index", "scg.ppo.k4": "aten::minimum",
                    "scg.ppo.optimizer": "aten::_foreach_addcmul_"}


@pytest.mark.parametrize("fast_rollout", [True, False], ids=["k3-plain", "general-engine"])
def test_ppo_train_step_spans(tmp_path, fast_rollout):
    """One train step on the CPU (K4's plain version) under the profiler:
    one span of the step, of collect, GAE and the pack; one shuffle, gather
    and transpose an epoch; one K4 and one optimizer span a minibatch; each
    leaf encloses its phase's operations (``SPAN_HOLDS``,
    ``SPAN_ALONE_HOLDS``).  The parameters after the step are bit for bit
    those of the same step run without the profiler."""
    cfg = tq.QuadrotorConfig(quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=0.25,
                             task="stabilization", cost="rl_reward", randomized_init=True,
                             normalized_rl_action_space=True)
    kw = dict(rollout_batch_size=16, rollout_steps=8, opt_epochs=2, mini_batch_size=32,
              use_fast_rollout=fast_rollout, use_fast_update=True)
    epochs, n_mini = 2, 16 * 8 // 32

    def step(traced):
        ppo = PPO(tq.make_quadrotor(cfg, device="cpu"), seed=3, **kw)
        if traced:
            with P.device_trace(str(tmp_path)):
                ppo.state, _ = ppo._train_step(ppo.state)
        else:
            ppo.state, _ = ppo._train_step(ppo.state)
        return [p.detach().clone() for p in ppo.state.ac.parameters()]

    plain = step(False)
    traced = step(True)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    rows = {r["name"]: r for r in P.summarize_spans(str(tmp_path))}
    assert {k: r["count"] for k, r in rows.items()} == {
        "scg.ppo.train_step": 1, "scg.ppo.collect": 1, "scg.ppo.gae": 1, "scg.ppo.pack": 1,
        "scg.ppo.shuffle": epochs, "scg.ppo.gather": epochs, "scg.ppo.transpose": epochs,
        "scg.ppo.k4": epochs * n_mini, "scg.ppo.optimizer": epochs * n_mini}
    leaves = sum(r["host_ms"] for k, r in rows.items() if k != "scg.ppo.train_step")
    assert 0 < leaves <= rows["scg.ppo.train_step"]["host_ms"]

    events = P._trace_events(str(tmp_path))
    spans = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("scg.")]
    held = {}  # operation -> the innermost spans that enclose it
    for e in events:
        if e.get("cat") != "cpu_op" or e["name"].startswith("scg."):
            continue
        around = [s for s in spans
                  if s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]]
        if around:
            held.setdefault(e["name"], set()).add(min(around, key=lambda s: s["dur"])["name"])
    for span, op in SPAN_HOLDS.items():
        assert span in held.get(op, set()), (span, op)
    for span, op in SPAN_ALONE_HOLDS.items():
        assert held.get(op) == {span}, (span, op, held.get(op))
