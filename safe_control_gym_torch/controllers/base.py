"""Controller protocol.

Port of ``safe_control_gym_tpu/controllers/base.py`` (reference
base_controller.py:6-90): ``reset`` / ``close`` / ``learn`` / ``save`` /
``load`` and the chunked training loop.  The JAX package's learners are pure
``train_step(state) -> (state, metrics)`` functions that ``train_many``
scans under one jit; here a train step runs eagerly and ``train_many`` is a
Python loop with the same contract.  The batched evaluation loop ``run()``
carries the reference's post-analysis and plots (``analysis=True``).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from safe_control_gym_torch.envs.benchmark import where_state
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils.checkpoint import load_checkpoint, save_checkpoint


class BaseController:
    """Host-side shell around a controller's ``state``.

    ``GENERATORS`` names the attributes holding the ``torch.Generator``s a
    learner draws from: the JAX package carries its PRNG keys inside the
    state, so ``save``/``load`` keep them together with it."""

    GENERATORS: tuple[str, ...] = ()

    def __init__(self, env, output_dir: str = ".", seed: int = 0, **kwargs):
        self.env = env
        self.output_dir = output_dir
        self.seed = seed
        self.state: Any = None

    def reset(self):
        pass

    def close(self):
        pass

    def learn(self, **kwargs):
        """Train loop; model-based controllers are no-ops."""

    def train_many(self, n: int):
        """A function ``state -> (state, metrics)`` that runs ``n`` train
        steps (``self._train_step``) and returns the LAST step's metrics, the
        contract of one train step."""
        def run(state):
            metrics = {}
            for _ in range(n):
                state, metrics = self._train_step(state)
            return state, metrics

        return run

    def _learn_chunked(self, n_iters: int, chunk: int = 8):
        """Advance ``self.state`` by ``n_iters`` train steps in chunks of
        ``train_many(chunk)``; returns the last metrics."""
        metrics = {}
        many = self.train_many(chunk)
        for _ in range(n_iters // chunk):
            self.state, metrics = many(self.state)
        for _ in range(n_iters % chunk):
            self.state, metrics = self._train_step(self.state)
        return metrics

    def select_action(self, obs, info=None):
        raise NotImplementedError

    def save(self, path):
        """Write the state and the generators named in ``GENERATORS``."""
        save_checkpoint(os.fspath(path), {
            "state": self.state, "generators": {n: getattr(self, n) for n in self.GENERATORS}})

    def load(self, path):
        """Restore what ``save`` wrote onto the env's device.  Each generator's
        state is set into the controller's own generator, so every reference
        to it (a collector's, say) draws the saved stream on."""
        saved, _, _ = load_checkpoint(os.fspath(path), device=getattr(self.env, "device", None))
        self.state = saved["state"]
        for name, gen in saved["generators"].items():
            getattr(self, name).set_state(gen.get_state())

    @torch.no_grad()
    def run(self, num_episodes: int = 1, max_steps: int | None = None, seed: int = 0,
            env_seeds=None, analysis: bool = False, plot: bool = False, plot_dir: str = "."):
        """Batched evaluation: ``num_episodes`` envs in parallel without
        auto-reset; an env that is done keeps its last state and obs and
        earns no more reward (base.py:95-160).  ``env_seeds`` (int32,
        ``(num_episodes,)``) wins over ``seed``, as in ``make_vec_env``'s
        reset.  Returns per-step obs/action/reward/done/mse stacks (time
        first, NumPy) and per-episode returns and lengths.

        ``analysis=True`` adds the reference's post-analysis of env 0
        (``utils/plotting.py::post_analysis``): per-state RMSE against the
        goal stack, angle errors wrapped, and with ``plot=True`` the state
        and input plots saved under ``plot_dir``."""
        vec = make_vec_env(self.env, num_episodes, auto_reset=False)
        state, obs, _ = vec.reset(seed=seed, env_seeds=env_seeds)
        done_mask = torch.zeros(num_episodes, dtype=torch.bool, device=obs.device)
        recs = []
        for _ in range(max_steps or self.env.max_episode_steps):
            act = self._policy(obs)
            new_state, new_obs, rew, done, info = vec.step_no_reset(state, act)
            state = where_state(done_mask, state, new_state)
            obs = torch.where(done_mask[:, None], obs, new_obs)
            rew = torch.where(done_mask, torch.zeros_like(rew), rew)
            recs.append({"obs": obs, "action": act, "reward": rew, "done": done,
                         "mse": info["mse"]})
            done_mask = done_mask | done
        traj = {k: torch.stack([r[k] for r in recs]).cpu().numpy() for k in recs[0]}
        results = {**traj, "ep_returns": traj["reward"].sum(0),
                   "ep_lengths": (~traj["done"]).sum(0) + 1}
        if analysis:
            from safe_control_gym_torch.utils.plotting import post_analysis

            T, x_goal = traj["obs"].shape[0], np.asarray(self.env.x_goal)
            if x_goal.ndim == 1:
                goal = np.tile(x_goal[None], (T, 1))
            else:
                goal = x_goal[np.clip(np.arange(T), 0, x_goal.shape[0] - 1)]
            nx = x_goal.shape[-1]
            results["analysis"] = post_analysis(
                goal, traj["obs"][:, 0, :nx], traj["action"][:, 0], env=self.env, plot=plot,
                save_plot=plot, plot_dir=plot_dir)
        return results

    def _policy(self, obs):
        """Batched policy the evaluation loop uses; subclasses override."""
        raise NotImplementedError
