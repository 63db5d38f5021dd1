#!/usr/bin/env python3
"""Train PPO on CartPole stabilization end to end with the port's
experiment infra: the counterpart of ``examples/rl_training.py``.

The workflow of the reference: a config (``ConfigFactory``: the registry's
defaults for ``--algo ppo --task cartpole`` merged with this script's
overrides), the registry's ``make`` of the env and the controller, ``learn``
with an ``ExperimentLogger``, ``save``, evaluation before and after, and a
learning curve from the logs.  Runs on the card unless ``--device cpu``:

    python3 scripts/rl_training_port.py --steps 150000 --out results/ppo_run

Writes the config, the metric logs, the checkpoint and the learning-curve
plot (where matplotlib is installed) under ``--out`` and prints the eval
return before and after training.
"""

from __future__ import annotations

import argparse
import os
import sys

TASK = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=5, task="stabilization",
            cost="rl_reward", randomized_init=True)
ALGO = dict(rollout_batch_size=64, rollout_steps=100, opt_epochs=10, mini_batch_size=1600)


def main(max_steps=150_000, out_dir="results/ppo_run", seed=0, device=None, eval_episodes=5,
         **algo_overrides):
    from safe_control_gym_torch import make
    from safe_control_gym_torch.utils.configuration import ConfigFactory, save_config
    from safe_control_gym_torch.utils.logging import ExperimentLogger
    from safe_control_gym_torch.utils.plotting import plot_from_logs
    from safe_control_gym_torch.utils.rendering import have_matplotlib

    config = ConfigFactory().merge(
        args=["--algo", "ppo", "--task", "cartpole", "--seed", str(seed), "--output_dir", out_dir],
        config_override={"task_config": TASK, "algo_config": {**ALGO, **algo_overrides}})
    save_config(config, out_dir)
    env = make(config.task, device=device, **config.task_config)
    ppo = make(config.algo, env, seed=config.seed, **config.algo_config)
    logger = ExperimentLogger(out_dir, log_std_out=False)

    def log_fn(step, metrics):
        logger.add_scalars(metrics, step, prefix="train")

    before = float(ppo.run(num_episodes=eval_episodes)["ep_returns"].mean())
    print(f"eval return before training: {before:.1f} ({env.device})")
    ppo.learn(max_env_steps=max_steps, log_fn=log_fn)
    ppo.save(os.path.join(out_dir, "checkpoint"))
    logger.dump_scalars()
    after = float(ppo.run(num_episodes=eval_episodes)["ep_returns"].mean())
    print(f"eval return after training:  {after:.1f}")
    if have_matplotlib():
        curve = os.path.join(out_dir, "learning_curve.png")
        plot_from_logs([out_dir], metric="train/policy_loss", out_path=curve)
        print("learning curve:", curve, "(train/policy_loss)")
    else:
        print("learning curve: not drawn (matplotlib is not installed); the logs are in",
              os.path.join(out_dir, "logs"))
    logger.close()
    return before, after


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=150_000)
    p.add_argument("--out", default="results/ppo_run")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    a = p.parse_args()
    main(a.steps, a.out, a.seed, a.device)
