"""The metric arithmetic on synthetic traces: the 95th percentile over all
steps, busy and idle time, roofline and mfu shares."""

from __future__ import annotations

import math
import statistics
import types

import pytest

from portbench import families, harness, trace, yardstick
from portbench.metrics import _shapes


def test_p95_is_over_every_step():
    values = [float(v) for v in range(1, 201)]
    assert harness.p95(values) == statistics.quantiles(values, n=20)[-1]
    assert 190.0 < harness.p95(values) < 191.0
    assert harness.p95([5.0]) == 5.0


def _job(family="quad3d", B=32768, T=128, hidden=64, minibatches=4):
    cfg = {"family": family, "ppo": {"hidden_dim": hidden, "opt_epochs": 10},
           "program": {"policy_kernel": "policy_k", "update_kernels": ["ppo_grads_kernel",
                                                                      "ppo_pack", "ppo_reduce"]}}
    cell = types.SimpleNamespace(config=cfg, traffic={"minibatches": minibatches})
    return types.SimpleNamespace(cell=cell, B=B, T=T)


def _counts(family):
    fam = families.load(family)
    return fam.STEP_OPS, fam.STATE_ROWS


def _trace(ops, start=0, end=1000, units=1, job=None, host=()):
    return trace.Trace(device_ops=list(ops), host_ops=list(host), start_ns=start, end_ns=end,
                       units=units, job=job or _job())


def test_busy_merges_overlaps_and_clips_to_the_window():
    tr = _trace([("a", 100, 300), ("b", 200, 400), ("c", 900, 1200), ("d", 500, 600)])
    assert tr.busy_s() == pytest.approx((300 + 100 + 100) * 1e-9)
    assert _shapes.idle_share(tr) == pytest.approx(50.0)


def test_idle_gaps_are_labelled_by_the_open_host_operation():
    host = [("aten::randperm", 0, 450), ("cudaLaunchKernel", 440, 445), ("outer", 0, 1000)]
    tr = _trace([("k", 100, 300), ("k", 500, 1000)], end=1100, host=host)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::randperm"] == pytest.approx(300e-9)  # 0-100 and 300-500
    assert gaps["host: between operations"] == pytest.approx(100e-9)  # 1000-1100


def test_top_ops_sum_by_name():
    tr = _trace([("k", 0, 100), ("k", 200, 300), ("m", 300, 350)])
    assert tr.top_ops() == [["k", pytest.approx(200e-9)], ["m", pytest.approx(50e-9)]]


def test_roofline_shares():
    job = _job()
    least = yardstick.least_seconds(*yardstick.policy_call(*_counts("quad3d"), 12, 4, 64, 32768, 128))
    dur = int(round(least * 10 * 1e9))  # the kernel at a tenth of its roofline
    tr = _trace([("void policy_k<64>", 0, dur), ("void policy_k<64>", dur, 2 * dur)],
                end=3 * dur, units=2, job=job)
    assert _shapes.policy_roofline(tr) == pytest.approx(10.0, rel=1e-6)
    k4 = yardstick.least_seconds(*yardstick.update_call(12, 4, 64, 32768 * 128 // 4))
    d = int(round(k4 * 4 * 1e9))  # grads + pack + reduce of one launch at 25%
    ops = [("ppo_grads_kernel", 0, d - 20), ("ppo_pack", d - 20, d - 10), ("ppo_reduce", d - 10, d)]
    read = harness._module(harness.PKG / "metrics" / "ppo_update_kernel_roofline.py", "k4r").read
    assert read(_trace(ops, end=d, job=job)) == pytest.approx(25.0, rel=1e-6)


def test_shares_are_never_above_100_for_a_kernel_at_its_bound():
    job = _job(family="cartpole")
    least = yardstick.least_seconds(*yardstick.policy_call(*_counts("cartpole"), 4, 1, 64, 32768, 128))
    dur = math.ceil(least * 1e9)
    tr = _trace([("policy_k", 0, dur)], end=dur, job=job)
    assert _shapes.policy_roofline(tr) <= 100.0 + 1e-6


def test_mfu_counts_the_whole_step_over_the_window():
    job = _job()
    ops = yardstick.model_ops_train_step(families.load("quad3d").STEP_OPS, 12, 4, 64, 32768, 128, 10, 4)
    window = ops / yardstick.PEAK_F32_OPS_S * 4  # 25% of peak a step
    tr = _trace([("x", 0, 10)], end=int(round(3 * window * 1e9)), units=3, job=job)
    read = harness._module(harness.PKG / "metrics" / "mfu.train.py", "mfu").read
    assert read(tr) == pytest.approx(25.0, rel=1e-6)


def test_readers_find_nothing_to_read():
    tr = _trace([("other", 0, 10)])
    assert _shapes.policy_roofline(tr) is None
    read = harness._module(harness.PKG / "metrics" / "ppo_update_kernel_roofline.py", "k4r").read
    assert read(tr) is None
