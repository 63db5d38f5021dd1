"""Per-flight state/control logging.

Port of ``safe_control_gym_tpu/utils/drone_logger.py`` (the counterpart of
the reference's drone Logger, safe_control_gym/envs/gym_pybullet_drones/
Logger.py:9-416): arrays of 16 state and 12 control channels per drone,
grown as needed, with save, CSV export and a 6x2 grid of plots.  Host
NumPy: pass it host copies of the states.
"""

from __future__ import annotations

import os

import numpy as np

STATE_CHANNELS = [
    "x", "y", "z", "vx", "vy", "vz", "roll", "pitch", "yaw",
    "p", "q", "r", "rpm0", "rpm1", "rpm2", "rpm3",
]
CONTROL_CHANNELS = [
    "ux", "uy", "uz", "uvx", "uvy", "uvz", "uroll", "upitch", "uyaw",
    "up", "uq", "ur",
]


class DroneLogger:
    def __init__(self, logging_freq_hz: int, duration_sec: float = 0.0, num_drones: int = 1):
        self.freq = logging_freq_hz
        self.num_drones = num_drones
        n = int(duration_sec * logging_freq_hz) if duration_sec else 0
        self.preallocated = n > 0
        self.counters = np.zeros(num_drones, dtype=int)
        self.timestamps = np.zeros((num_drones, n))
        self.states = np.zeros((num_drones, 16, n))
        self.controls = np.zeros((num_drones, 12, n))

    def log(self, drone: int, timestamp: float, state, control=np.zeros(12)):
        i = self.counters[drone]
        if not self.preallocated or i >= self.timestamps.shape[1]:
            grow = max(self.timestamps.shape[1], 64)
            self.timestamps = np.concatenate([self.timestamps, np.zeros((self.num_drones, grow))], 1)
            self.states = np.concatenate([self.states, np.zeros((self.num_drones, 16, grow))], 2)
            self.controls = np.concatenate([self.controls, np.zeros((self.num_drones, 12, grow))], 2)
            self.preallocated = True
        self.timestamps[drone, i] = timestamp
        s = np.zeros(16)
        s[: len(state)] = np.asarray(state)[:16]
        c = np.zeros(12)
        c[: len(control)] = np.asarray(control)[:12]
        self.states[drone, :, i] = s
        self.controls[drone, :, i] = c
        self.counters[drone] += 1

    def save(self, path: str):
        np.savez(path, timestamps=self.timestamps, states=self.states, controls=self.controls,
                 counters=self.counters)

    def save_as_csv(self, comment: str, out_dir: str = "."):
        os.makedirs(out_dir, exist_ok=True)
        header = "t," + ",".join(STATE_CHANNELS + CONTROL_CHANNELS)
        for d in range(self.num_drones):
            n = self.counters[d]
            data = np.concatenate(
                [self.timestamps[d, :n][None], self.states[d, :, :n], self.controls[d, :, :n]], 0
            ).T
            np.savetxt(os.path.join(out_dir, f"{comment}_drone{d}.csv"), data, delimiter=",",
                       header=header, comments="")

    def plot(self, out_path: str | None = None):
        """6x2 grid of the position, velocity, attitude and rate channels
        (reference Logger.plot)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(6, 2, figsize=(10, 12))
        chans = ["x", "y", "z", "vx", "vy", "vz", "roll", "pitch", "yaw", "p", "q", "r"]
        for d in range(self.num_drones):
            n = self.counters[d]
            t = self.timestamps[d, :n]
            for k, ch in enumerate(chans):
                ax = axs[k % 6, k // 6]
                ax.plot(t, self.states[d, STATE_CHANNELS.index(ch), :n])
                ax.set_ylabel(ch)
        axs[5, 0].set_xlabel("t [s]")
        axs[5, 1].set_xlabel("t [s]")
        if out_path:
            fig.savefig(out_path, dpi=110, bbox_inches="tight")
            plt.close(fig)
        return fig
