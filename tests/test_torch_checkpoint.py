"""The port's checkpoint/resume (``utils/checkpoint.py``): the counterpart of
tests/test_checkpoint.py.  A PPO training state saved together with the
controller's ``torch.Generator`` resumes bit for bit on the CPU (params,
optimizer moments and counts, env state, observation, normalizers, step
count and the generator's state); an env state alone round-trips; and
``latest_checkpoint`` picks the highest step."""

import os

import numpy as np
import torch

from safe_control_gym_torch.controllers.ppo import PPO
from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole
from safe_control_gym_torch.utils.checkpoint import (latest_checkpoint, load_checkpoint,
                                                     save_checkpoint)


def _tensors(obj, seen=None):
    """Every tensor reachable from a state (dataclasses, modules, optimizers,
    dicts, lists), in a fixed order."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj.detach()]
    if isinstance(obj, torch.nn.Module):
        return [t.detach() for t in obj.state_dict().values()]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _tensors(obj[k], seen)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v, seen)]
    if hasattr(obj, "__dict__"):
        return [t for k in sorted(vars(obj)) for t in _tensors(vars(obj)[k], seen)]
    return []


def test_bitwise_resume(tmp_path):
    env = make_cartpole(CartPoleConfig(task="stabilization", cost="rl_reward",
                                       normalized_rl_action_space=True, episode_len_sec=2),
                        device="cpu")
    ppo = PPO(env, seed=0, rollout_batch_size=4, rollout_steps=20, opt_epochs=2,
              mini_batch_size=40, norm_obs=True)
    ppo.state, _ = ppo._train_step(ppo.state)
    path = str(tmp_path / "ckpt_1.pkl")
    save_checkpoint(path, {"state": ppo.state, "gen": ppo.gen}, step=1, metadata={"tag": "a"})
    assert not os.path.exists(path + ".tmp")
    for _ in range(2):  # the state advances in place
        ppo.state, _ = ppo._train_step(ppo.state)
    s_a, gen_a = ppo.state, ppo.gen

    restored, step, meta = load_checkpoint(path, device="cpu")
    assert step == 1 and meta == {"tag": "a"}
    s_b = restored["state"]
    # One object per parameter: the optimizer steps the module's own.
    assert s_b.actor_opt.params[0] is s_b.ac.actor.layers[0].weight
    assert isinstance(s_b.ac.logstd, torch.nn.Parameter) and s_b.ac.logstd.requires_grad
    ppo.gen = restored["gen"]
    assert ppo.gen.device.type == "cpu"
    for _ in range(2):
        s_b, _ = ppo._train_step(s_b)

    ta, tb = _tensors(s_a), _tensors(s_b)
    assert len(ta) == len(tb) > 20
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert s_a.total_steps == s_b.total_steps == 3 * 80
    assert s_a.actor_opt.count == s_b.actor_opt.count
    assert torch.equal(gen_a.get_state(), ppo.gen.get_state())


def test_env_state_checkpoint_roundtrip(tmp_path):
    """The env state alone is a complete resume artifact."""
    env = make_cartpole(CartPoleConfig(episode_len_sec=2), device="cpu")
    state, obs, _ = env.reset(torch.tensor([3, 4], dtype=torch.int32))
    state, *_ = env.step(state, torch.tensor([[1.0], [-0.5]]))
    path = str(tmp_path / "env.pkl")
    save_checkpoint(path, state)
    restored, step, meta = load_checkpoint(path)
    assert step is None and meta == {}
    a = torch.tensor([[0.5], [0.25]])
    s1, o1, r1, d1, _ = env.step(state, a)
    s2, o2, r2, d2, _ = env.step(restored, a)
    assert torch.equal(o1, o2) and torch.equal(r1, r2) and torch.equal(d1, d2)
    assert torch.equal(s1.x, s2.x) and torch.equal(s1.ctrl_step, s2.ctrl_step)


def test_latest_checkpoint_picks_the_highest_step(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for n in (1, 10, 2):
        save_checkpoint(str(tmp_path / f"ckpt_{n}.pkl"), {"x": torch.tensor([n])}, step=n)
    (tmp_path / "other.txt").write_text("not a checkpoint")
    best = latest_checkpoint(str(tmp_path))
    assert best == str(tmp_path / "ckpt_10.pkl")
    state, step, _ = load_checkpoint(best)
    assert step == 10 and torch.equal(state["x"], torch.tensor([10]))
    assert np.asarray(state["x"]).dtype == np.int64
