"""Resume through ``save``/``load`` (``controllers/base.py``): a learner
trained k steps, saved, loaded into a fresh controller of the same seed and
trained m more steps ends bit for bit where k + m uninterrupted steps end:
every tensor of the state (parameters, optimizer moments, normalizers, env
state, observation, replay buffer), the step count and the generators'
states.  The JAX package carries its PRNG keys in the state its ``save``
pickles, so its resumed run continues its stream; the port keeps its keys
in ``torch.Generator``s beside the state, named by each learner's
``GENERATORS``, and ``load`` sets them into the controller's own
generators.  Small CartPole configs on the CPU."""

import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.ddpg import DDPG
from safe_control_gym_torch.controllers.ppo import PPO
from safe_control_gym_torch.controllers.rarl import RAP, RARL
from safe_control_gym_torch.controllers.sac import SAC
from safe_control_gym_torch.controllers.safe_explorer import SafeExplorerPPO
from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole
from test_torch_checkpoint import _tensors

BASE = dict(task="stabilization", cost="rl_reward", normalized_rl_action_space=True,
            randomized_init=True, episode_len_sec=0.5)
PPO_KW = dict(rollout_batch_size=4, rollout_steps=20, opt_epochs=2, mini_batch_size=40)
OFF_KW = dict(hidden_dim=32, rollout_batch_size=4, train_interval=10, warm_up_steps=60,
              train_batch_size=32, max_buffer_size=400)
CONSTRAINED = dict(BASE, constraints=(
    {"constraint_form": "default_constraint", "constrained_variable": "state",
     "upper_bounds": [1.0, 10.0, 0.3, 10.0], "lower_bounds": [-1.0, -10.0, -0.3, -10.0]},))

# id -> (controller class, env config, controller kwargs, k, m)
LEARNERS = {
    "ppo": (PPO, BASE, dict(PPO_KW, norm_obs=True, norm_reward=True), 2, 2),
    "ppo_fast_rollout": (PPO, BASE, dict(PPO_KW, use_fast_rollout=True), 2, 2),
    "sac": (SAC, BASE, dict(OFF_KW, use_entropy_tuning=True), 2, 3),
    "ddpg": (DDPG, BASE, OFF_KW, 2, 3),
    "rarl": (RARL, dict(BASE, adversary_disturbance="dynamics", adversary_disturbance_scale=0.1),
             PPO_KW, 1, 2),
    "rap": (RAP, dict(BASE, adversary_disturbance="dynamics", adversary_disturbance_scale=0.1),
            dict(PPO_KW, num_adversaries=3), 2, 2),
    "safe_explorer_ppo": (SafeExplorerPPO, CONSTRAINED, dict(PPO_KW, pretrain_steps=20), 1, 2),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: these small-batch loops launch many short
    parallel regions, which stall when the test workers outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(name):
    cls, env_cfg, kw, _, _ = LEARNERS[name]
    ctrl = cls(make_cartpole(CartPoleConfig(**env_cfg), device="cpu"), seed=3, **kw)
    if isinstance(ctrl, SafeExplorerPPO):
        ctrl.pretrain()  # the safety layer is the controller's, not its state's
    return ctrl


def train(ctrl, n):
    for _ in range(n):
        ctrl.state, metrics = ctrl._train_step(ctrl.state)
    return metrics


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_save_load_train_equals_uninterrupted(name, tmp_path):
    k, m = LEARNERS[name][3:]
    straight = build(name)
    train(straight, k + m)

    first = build(name)
    train(first, k)
    path = tmp_path / f"{name}.pkl"
    first.save(path)

    resumed = build(name)
    assert resumed.GENERATORS and "gen" in resumed.GENERATORS
    # The fresh controller's stream is not the saved one until load.
    assert not torch.equal(resumed.gen.get_state(), first.gen.get_state())
    gen_objects = [getattr(resumed, g) for g in resumed.GENERATORS]
    resumed.load(path)
    assert all(getattr(resumed, g) is o for g, o in zip(resumed.GENERATORS, gen_objects))
    for g in resumed.GENERATORS:
        assert torch.equal(getattr(resumed, g).get_state(), getattr(first, g).get_state())
    metrics = train(resumed, m)
    assert all(np.isfinite(float(v)) for v in metrics.values())

    ta, tb = _tensors(straight.state), _tensors(resumed.state)
    assert len(ta) == len(tb) > 10
    for x, y in zip(ta, tb):  # as bytes: the fast rollout's rows carry seeds as float bits
        assert x.dtype == y.dtype and torch.equal(x.reshape(-1).view(torch.uint8),
                                                  y.reshape(-1).view(torch.uint8))
    assert straight.state.total_steps == resumed.state.total_steps > 0
    for g in straight.GENERATORS:
        assert torch.equal(getattr(straight, g).get_state(), getattr(resumed, g).get_state())


def test_load_restores_the_stream_a_later_draw_reads(tmp_path):
    """After ``load`` the controller's generator object continues the saved
    stream: a draw taken after loading equals the draw the saved controller
    takes next (the fast collector keeps this object)."""
    a = build("ppo_fast_rollout")
    train(a, 1)
    b = build("ppo_fast_rollout")
    gen_b = b.gen
    a.save(tmp_path / "a.pkl")
    b.load(tmp_path / "a.pkl")
    want = torch.randint(0, 2**31 - 1, (4,), generator=a.gen)
    got = torch.randint(0, 2**31 - 1, (4,), generator=gen_b)
    assert torch.equal(want, got)
