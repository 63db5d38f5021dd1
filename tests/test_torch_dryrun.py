"""The port's dry runs (``parallel/dryrun.py``, the counterparts of
``__graft_entry__.py::dryrun_multichip`` and ``::dryrun_multihost``) on CPU
clusters: the three asserted paths of the multichip dry run on 2 ranks (K2
and K4 are their plain versions here, 256 envs and a 256-sample minibatch a
rank), and the validation worker on 2 x 2 ranks."""

import math

from safe_control_gym_torch.parallel import dryrun


def test_dryrun_multichip_on_two_cpu_ranks():
    out = dryrun.dryrun_multichip(2, device="cpu", timeout=300.0)
    assert out["ranks"] == 2 and out["backend"] == "gloo" and out["device"] == "cpu"
    # (1) the sharded PPO step: B x T env steps, a finite loss
    assert out["ppo"]["total_steps"] == out["ppo"]["envs"] * 4 == 32
    assert math.isfinite(out["ppo"]["policy_loss"])
    # (2) K2 under the group, bit-equal to the sequential calls (asserted in
    # every rank), and episodes completed within the call
    assert out["k2"]["bit_equal"] and out["k2"]["envs_per_rank"] == 256
    assert out["k2"]["episodes"] > 0
    # (3) K4's all-reduced gradients against the sequential sum
    assert out["k4"]["mb_per_rank"] == 256 and out["k4"]["max_abs_err"] <= 2e-5
    # The wrappers count launches of the CUDA kernels only: none on the CPU.
    assert out["launches"] == {"k1": 0, "k2": 0, "k4": 0}


def test_dryrun_multihost_on_two_by_two_cpu_ranks():
    stats = dryrun.dryrun_multihost(2, 2, device="cpu", timeout=300.0)
    assert stats["episodes"] > 0 and stats["total_steps"] == 32 * 4
    assert math.isfinite(stats["ppo_policy_loss"])
