"""Each fault a cell can have, planted under the timed path, turns
``correct`` false; the control (the reference in TF32 in the program's
place) fails at least one of a cell's numbers.  The harness's look for a
card is skipped: the program runs its kernels' plain versions here."""

from __future__ import annotations

import pb_helpers
import pytest
import torch

from portbench import harness
from portbench.calibrate import collect_control
from portbench.reference import check

TRAIN = ["quad3d_fig8_ppo.train_b32k", "cartpole_stab_ppo.train_b32k"]
COLLECT = ["quad3d_fig8_ppo.collect_b16k"]


def _state_unchanged_train(mp):
    from safe_control_gym_torch.controllers.ppo import PPO

    def step(self, state, eps=None, perm=None):
        z = torch.zeros(())
        return state, {k: z for k in check.LOSS_KEYS}

    mp.setattr(PPO, "_train_step", step)


def _half_batch_train(mp):
    from safe_control_gym_torch.controllers.ppo import PPO

    for name in ("minibatch_step", "minibatch_step_kernel"):
        orig = getattr(PPO, name)
        half = (lambda o: lambda self, state, rows: o(
            self, state, rows[: rows.shape[0] // 2] if o.__name__ == "minibatch_step"
            else rows[:, : rows.shape[1] // 2]))(orig)
        mp.setattr(PPO, name, half)


def _reward_altered_train(mp):
    from safe_control_gym_torch.controllers.ppo import PPO

    orig = PPO.collect_fast

    def collect(self, state):
        roll = orig(self, state)
        roll["rew"] = roll["rew"].clone()
        roll["rew"][0] = 0.0
        return roll

    mp.setattr(PPO, "collect_fast", collect)


def _state_unchanged_collect(mp):
    from safe_control_gym_torch.parallel import fast_env

    orig = fast_env.step_rows

    def step_rows(p, carry, thrust_rows, act_rows, noise=None):
        new_rows, rew, done, trunc, violf, s_post = orig(p, carry, thrust_rows, act_rows, noise)
        return list(carry[:12]) + new_rows[12:], rew, done, trunc, violf, list(carry[:12])

    mp.setattr(fast_env, "step_rows", step_rows)


def _half_batch_collect(mp):
    from safe_control_gym_torch.parallel import fast_policy

    orig = fast_policy.policy_rollout

    def rollout(p, rows, weights, seed):
        h = rows.shape[1] // 2
        out, traj = orig(p, rows[:, :h].contiguous(), weights, seed)
        full = torch.zeros((traj.shape[0], traj.shape[1], rows.shape[1]), dtype=traj.dtype)
        full[..., :h] = traj
        return torch.cat([out, rows[:, h:]], 1), full

    mp.setattr(fast_policy, "policy_rollout", rollout)


def _answer_altered_collect(mp):
    from safe_control_gym_torch.parallel import fast_policy

    orig = fast_policy.policy_rollout

    def rollout(p, rows, weights, seed):
        out, traj = orig(p, rows, weights, seed)
        traj = traj.clone()
        traj[5, 12, 3] += 0.01  # one action of one env at one step
        return out, traj

    mp.setattr(fast_policy, "policy_rollout", rollout)


FAULTS = [(c, f) for c in TRAIN for f in (_state_unchanged_train, _half_batch_train,
                                          _reward_altered_train)]
FAULTS += [(c, f) for c in COLLECT for f in (_state_unchanged_collect, _half_batch_collect,
                                             _answer_altered_collect)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_turns_correct_false(cell, fault, monkeypatch):
    correct, _ = pb_helpers.run_small(cell)
    assert correct
    fault(monkeypatch)
    correct, numbers = pb_helpers.run_small(cell)
    assert not correct, numbers


@pytest.mark.parametrize("cell", TRAIN)
def test_train_control_is_not_correct(cell):
    c = pb_helpers.small_cell(cell)
    dev = torch.device("cpu")
    job = harness.driver(c).Job(c, pb_helpers.SEED, dev)
    ref = check.train_reference(c, job.w0, pb_helpers.SEED, dev, len(job.losses))
    ctrl = check.train_reference(c, job.w0, pb_helpers.SEED, dev, len(job.losses), "tf32")
    numbers = check.train_numbers(ctrl, ref, c.config["ppo"])
    assert any(numbers[k] > v for k, v in c.limits["limits"].items()), numbers


@pytest.mark.parametrize("cell", COLLECT)
def test_collect_control_is_not_correct(cell):
    c = pb_helpers.small_cell(cell)
    job = harness.driver(c).Job(c, pb_helpers.SEED, torch.device("cpu"))
    for _ in range(int(c.traffic["sample_range"])):
        job.unit()
    numbers = collect_control(job)
    assert numbers["record_gap"] > c.limits["limits"]["record_gap"], numbers


def test_collect_sampled_call_never_made_is_not_correct():
    c = pb_helpers.small_cell(COLLECT[0])
    c.traffic["cpu_units"] = 0  # the run makes the first call alone
    res, numbers = harness.run_cell(c, pb_helpers.SEED, 1.0, False, torch.device("cpu"), 0.0)
    assert numbers["sampled_calls_missing"] > 0 and not res["correct"], numbers


def test_collect_samples_only_calls_a_traced_run_makes():
    c = pb_helpers.small_cell(COLLECT[0])
    c.traffic["trace_units"] = int(c.traffic["sample_range"]) - 1
    with pytest.raises(ValueError, match="sample_range"):
        harness.driver(c).Job(c, pb_helpers.SEED, torch.device("cpu"))
