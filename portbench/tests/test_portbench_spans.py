"""The program's phase spans (``utils/profiling.py::annotate``) in the
benchmark's traced window on the card (marker ``card``): what they add to
the trace, and the split of a train step's device time by
``summarize_spans``.  Lives here, not in ``tests/``, because the card has
no JAX and ``tests/conftest.py`` imports it."""

from __future__ import annotations

import contextlib

import pytest

from portbench import harness, trace

CELL = "quad3d_fig8_ppo.train_b32k"
LEAVES = {"scg.ppo.collect", "scg.ppo.gae", "scg.ppo.pack", "scg.ppo.shuffle",
          "scg.ppo.gather", "scg.ppo.k4", "scg.ppo.optimizer"}


@pytest.mark.card
def test_spans_on_the_card(tmp_path, monkeypatch):
    """One traced train step of the quadrotor cell as the benchmark runs it
    (32,768 envs x 128 steps, 10 epochs of 4 minibatches), in the harness's
    session and window, with the spans and without: the two exported traces
    hold as many device operations, every one launched inside the step
    span; by the profiler's correlation ids the leaf spans launch all but 3%
    of the step span's device ms, and the K4 span's device ms are within 5%
    of K4's kernels in the same trace.  Counts come from the exported
    traces: ``trace.read`` of a second session in one process was seen to
    miss up to 1.4% of them."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from safe_control_gym_torch.controllers import ppo as ppo_module
    from safe_control_gym_torch.utils import profiling

    cell = harness.resolve(CELL)
    job = harness.driver(cell).Job(cell, 2**31 + 977, torch.device("cuda"))

    def traced_step(out):
        with trace.session() as prof:
            with trace.window_span():
                job.unit()
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(tmp_path / out / "trace.json"))
        return str(tmp_path / out)

    def device_ops(trace_dir):
        return sum(1 for e in profiling._trace_events(trace_dir)
                   if e.get("cat") in profiling.DEVICE_CATEGORIES
                   and profiling.LEAD_KERNEL not in e["name"])

    (tmp_path / "bare").mkdir()
    (tmp_path / "spans").mkdir()
    with monkeypatch.context() as m:
        m.setattr(ppo_module, "annotate", lambda name: contextlib.nullcontext())
        bare = traced_step("bare")
    spans = traced_step("spans")
    job.free()
    rows = {r["name"]: r for r in profiling.summarize_spans(spans)}
    step = rows.pop("scg.ppo.train_step")
    # A leaf that opens empty on this path (``scg.ppo.transpose`` on K4's
    # since the layout kernel) launches nothing and is no leaf here.
    assert step["count"] == 1 and {n for n, r in rows.items() if r["device_ops"]} == LEAVES
    assert all(r["launches"] == 0 for n, r in rows.items() if n not in LEAVES), rows
    assert device_ops(spans) == device_ops(bare) == step["device_ops"] > 0
    leaves = sum(r["device_ms"] for r in rows.values())
    assert leaves == pytest.approx(step["device_ms"], rel=0.03)
    names = cell.config["program"]["update_kernels"]
    k4 = [k for k in profiling.summarize_kernels(spans, top=10**6)
          if any(n in k["name"] for n in names)]
    assert sum(k["count"] for k in k4) >= 40  # a gradient kernel a minibatch at least
    assert rows["scg.ppo.k4"]["device_ms"] == pytest.approx(
        1e-3 * sum(k["total_us"] for k in k4), rel=0.05)
