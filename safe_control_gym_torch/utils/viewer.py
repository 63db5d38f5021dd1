"""Live viewer, the reference's PyBullet debug-GUI analogue.

Port of ``safe_control_gym_tpu/utils/viewer.py``.  The reference opens a
PyBullet GUI window (``p.connect(p.GUI)``, base_aviary.py:150-189), prints
the episode time onto it (getting_started.py:148-151) and paces the host
loop to the wall clock with ``sync`` (competition getting_started.py:
245-246).  Here the live view is the matplotlib 3D scene of
:mod:`safe_control_gym_torch.utils.rendering` kept open in an interactive
window: the static maze (gates, obstacles, reference trajectory) is drawn
once, and only the drone and the HUD text are redrawn a frame.

Without a display the viewer records instead: ``update`` keeps RGB frames
and ``close(save_path=...)`` writes the video, so a caller can pass
``gui=True`` on any host.  That choice is about a window; the viewer takes
host copies of the state whatever device the env runs on.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from safe_control_gym_torch.utils.rendering import (_pose_from_state, draw_quadrotor_drone,
                                                    draw_quadrotor_scene, render_quadrotor,
                                                    save_video)

__all__ = ["LiveViewer", "sync"]


def sync(i: int, start_time: float, timestep: float) -> None:
    """Sleep so that step ``i`` lands at wall-clock time ``start_time +
    i * timestep`` (reference safe_control_gym/utils/utils.py ``sync``)."""
    elapsed = time.time() - start_time
    if elapsed < i * timestep:
        time.sleep(i * timestep - elapsed)


class LiveViewer:
    """Live view of a quadrotor episode.

    The parameters are ``FrameRecorder``'s: pass ``env`` to take the maze
    (gates, obstacles, reference trajectory) from its config, or pass
    ``gates=/obstacles=/trajectory=/goal=``.  ``every`` keeps one redraw per
    N ``update`` calls.  ``interactive``: None (the default) tries to open a
    window and records where none opens; False records without trying;
    True raises where no window opens.
    """

    def __init__(self, env=None, every: int = 1, interactive: Optional[bool] = None,
                 arm_scale: float = 4.0, **scene_kwargs):
        self.every = max(int(every), 1)
        self.frames: list = []
        self._count = 0
        self._arm_scale = arm_scale
        self._quad_type = int(scene_kwargs.pop("quad_type", 3))
        self._scene = dict(scene_kwargs)
        if env is not None:
            cfg = env.config
            self._quad_type = int(getattr(cfg, "quad_type", self._quad_type))
            if getattr(cfg, "gates", None):
                self._scene.setdefault("gates", list(cfg.gates))
            if getattr(cfg, "obstacles", None):
                self._scene.setdefault("obstacles", list(cfg.obstacles))
            xg = np.asarray(env.x_goal)
            if xg.ndim == 2 and xg.shape[1] >= 6:
                self._scene.setdefault("trajectory", xg[:, [0, 2, 4]])
            elif xg.ndim == 1 and xg.shape[0] >= 6:
                self._scene.setdefault("goal", xg[[0, 2, 4]])
        self._fig = self._ax = self._hud = None
        self._drone_artists: list = []
        if interactive or interactive is None:
            self._try_open_window(required=bool(interactive))

    def _try_open_window(self, required: bool = False) -> None:
        try:
            import matplotlib
            import matplotlib.pyplot as plt

            # A host without a display raises when the window is made, not
            # on import, so the canvas is built to find out.
            if matplotlib.get_backend().lower() == "agg":
                if not os.environ.get("DISPLAY") and not required:
                    return  # stay headless without switching backends
                matplotlib.use("TkAgg", force=True)
            plt.ion()
            self._fig = plt.figure(figsize=(7.2, 5.4))
            self._ax = self._fig.add_subplot(projection="3d")
            draw_quadrotor_scene(self._ax, **self._scene)
            self._hud = self._ax.text2D(0.02, 0.97, "", transform=self._ax.transAxes)
            self._fig.show()
        except Exception:  # any backend's failure to open a window: record instead
            self._fig = self._ax = self._hud = None
            if required:
                raise

    @property
    def interactive(self) -> bool:
        return self._fig is not None

    def update(self, state_x, t: Optional[float] = None, reward: Optional[float] = None) -> None:
        """Show (or record) one frame of the env state vector ``state_x``."""
        if self._count % self.every:
            self._count += 1
            return
        self._count += 1
        if self._fig is None:
            self.frames.append(render_quadrotor(np.asarray(state_x), quad_type=self._quad_type,
                                                arm_scale=self._arm_scale, **self._scene))
            return
        import matplotlib.pyplot as plt

        pos, rpy = _pose_from_state(np.asarray(state_x), self._quad_type)
        for art in self._drone_artists:
            art.remove()
        self._drone_artists = draw_quadrotor_drone(self._ax, pos, rpy, arm_scale=self._arm_scale)
        hud = []
        if t is not None:
            hud.append(f"t = {t:6.2f} s")  # the GUI clock, getting_started.py:148
        if reward is not None:
            hud.append(f"r = {reward:+.2f}")
        self._hud.set_text("   ".join(hud))
        self._fig.canvas.draw_idle()
        plt.pause(1e-3)  # flush GUI events without blocking the loop

    def close(self, save_path: Optional[str] = None, fps: int = 30) -> Optional[str]:
        """Close the window; when recording, write the frames to
        ``save_path`` (GIF/MP4) and return the path written."""
        if self._fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self._fig)
            self._fig = self._ax = self._hud = None
        if save_path and self.frames:
            return save_video(self.frames, save_path, fps=fps)
        return None
