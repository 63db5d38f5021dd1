"""Host-facing episode-statistics wrapper with user-registered trackers.

Port of ``safe_control_gym_tpu/parallel/episode_stats.py``, the counterpart
of the reference's RecordEpisodeStatistics / VecRecordEpisodeStatistics
(env_wrappers/record_episode_statistics.py:11-169): per-episode return and
length plus user trackers with ``accumulate`` (sum an info value over the
episode) or ``queue`` (keep the last value) modes, emitted into a deque of
completed-episode records.

The on-device running sums live in ``rollout.EpisodeStats``; this wrapper
is the host-side drain for eval loops that step once per host iteration.
"""

from __future__ import annotations

from collections import deque

import numpy as np


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


class RecordEpisodeStatistics:
    """Wraps a ``VecEnv`` (``parallel/vector.py``) and collects episode
    statistics on the host."""

    def __init__(self, vec_env, deque_size: int = 10):
        self.vec = vec_env
        self.num_envs = vec_env.num_envs
        self.deque_size = deque_size
        self.trackers = {}  # name -> (mode, init)
        self.queued_stats = {"episode_return": deque(maxlen=deque_size),
                             "episode_length": deque(maxlen=deque_size)}
        self._reset_accumulators()

    def _reset_accumulators(self):
        self.ep_return = np.zeros(self.num_envs)
        self.ep_length = np.zeros(self.num_envs, dtype=int)
        self.ep_trackers = {name: np.full(self.num_envs, init, dtype=float)
                            for name, (mode, init) in self.trackers.items()}

    def add_tracker(self, name: str, init=0.0, mode: str = "accumulate"):
        """Register a tracked info field (record_episode_statistics.py:35-58)."""
        if mode not in ("accumulate", "queue"):
            raise ValueError(f"tracker mode is 'accumulate' or 'queue', not {mode!r}")
        self.trackers[name] = (mode, init)
        self.ep_trackers[name] = np.full(self.num_envs, init, dtype=float)
        self.queued_stats.setdefault(name, deque(maxlen=self.deque_size))

    def reset(self, seed: int = 0, env_seeds=None):
        """The vec env's reset (``seed`` or ``env_seeds``); clears the
        running sums."""
        out = self.vec.reset(seed=seed, env_seeds=env_seeds)
        self._reset_accumulators()
        return out

    def step(self, state, actions):
        state, obs, rew, done, info = self.vec.step(state, actions)
        rew_np, done_np = _np(rew), _np(done)
        self.ep_return += rew_np
        self.ep_length += 1
        for name, (mode, init) in self.trackers.items():
            if name in info:
                v = _np(info[name]).astype(float).reshape(self.num_envs, -1).sum(-1)
                if mode == "accumulate":
                    self.ep_trackers[name] += v
                else:
                    self.ep_trackers[name] = v
        for i in np.nonzero(done_np)[0]:
            self.queued_stats["episode_return"].append(float(self.ep_return[i]))
            self.queued_stats["episode_length"].append(int(self.ep_length[i]))
            for name in self.trackers:
                self.queued_stats[name].append(float(self.ep_trackers[name][i]))
            self.ep_return[i] = 0.0
            self.ep_length[i] = 0
            for name, (mode, init) in self.trackers.items():
                self.ep_trackers[name][i] = init
        # Episode record in info (record_episode_statistics.py:78-86).
        info = dict(info)
        info["episode"] = {"r": rew_np, "l": self.ep_length.copy()}
        return state, obs, rew, done, info

    def mean_stats(self):
        return {k: (float(np.mean(v)) if len(v) else float("nan"))
                for k, v in self.queued_stats.items()}
