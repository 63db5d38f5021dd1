"""Software rendering: RGB frames and video for the quadrotor/cartpole envs.

The port's copy of ``safe_control_gym_tpu/utils/rendering.py`` (NumPy and
matplotlib on the host), the counterpart of the reference's PyBullet
camera rendering
(reference base_aviary.py:324-410 ``render``/``_get_drone_images`` via
``p.getCameraImage``, quadrotor.py:570-577 ``render(mode='human')``, and
``utils/utils.py:169 save_video``).  There is no raster physics engine here,
so frames are drawn with a matplotlib 3D rasterizer on the host — rendering
is an offline/debug path and never touches the device loop.

``render_quadrotor`` draws the maze (gates as square apertures on posts,
obstacles as cylinders), the goal/reference trajectory, and the drone as a
cross of motor arms oriented by its Euler angles.  ``render_cartpole`` draws
the classic cart + pole side view.  ``save_video`` writes GIF (PIL, always
available) or MP4 (ffmpeg when present).

On a host without matplotlib (the port's card hosts may lack it) both
frames are drawn by PIL instead (``raster_quadrotor``, ``raster_cartpole``):
the same scene from the same fixed oblique view of the maze's box (CartPole:
the side view), in plain lines and discs.  Those frames are the port's own;
the matplotlib frames are the JAX package's pixel for pixel.
"""

from __future__ import annotations

import importlib.util
import io
from typing import Optional, Sequence

import numpy as np

__all__ = ["render_quadrotor", "render_cartpole", "save_video", "FrameRecorder",
           "draw_quadrotor_scene", "draw_quadrotor_drone", "raster_quadrotor", "raster_cartpole"]


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _fig_to_rgb(fig):
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="raw", dpi=fig.dpi)
    buf.seek(0)
    w, h = fig.canvas.get_width_height()
    img = np.frombuffer(buf.getvalue(), dtype=np.uint8).reshape(h, w, 4)[..., :3]
    plt.close(fig)
    return img


def _rot_xyz_np(phi, theta, psi):
    cphi, sphi = np.cos(phi), np.sin(phi)
    cth, sth = np.cos(theta), np.sin(theta)
    cpsi, spsi = np.cos(psi), np.sin(psi)
    rx = np.array([[1, 0, 0], [0, cphi, -sphi], [0, sphi, cphi]])
    ry = np.array([[cth, 0, sth], [0, 1, 0], [-sth, 0, cth]])
    rz = np.array([[cpsi, -spsi, 0], [spsi, cpsi, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _pose_from_state(state_x, quad_type: int):
    """Env state vector -> (pos(3,), rpy(3,)) for any QuadType."""
    x = np.asarray(state_x, dtype=float).reshape(-1)
    if quad_type == 1:
        return np.array([0.0, 0.0, x[0]]), np.zeros(3)
    if quad_type == 2:
        return np.array([x[0], 0.0, x[2]]), np.array([0.0, x[4], 0.0])
    return np.array([x[0], x[2], x[4]]), x[6:9]


def draw_quadrotor_scene(ax, gates=None, obstacles=None, goal=None,
                         trajectory=None):
    """Draw the static maze scene (grid, gates, obstacles, goal/reference)
    onto an existing 3D axes.  Shared by the offline rasterizer and the
    interactive ``LiveViewer`` so both show the same world."""
    ax.set_box_aspect((1, 1, 0.6))

    # Ground grid.
    g = np.linspace(-2.5, 2.5, 6)
    for v in g:
        ax.plot([v, v], [g[0], g[-1]], [0, 0], color="0.85", lw=0.6)
        ax.plot([g[0], g[-1]], [v, v], [0, 0], color="0.85", lw=0.6)

    # Gates: square aperture (edge 0.45) on a post (reference assets
    # portal.urdf h=1.0 / low_portal.urdf h=0.525).
    half = 0.45 / 2
    for gate in gates or []:
        gate = np.asarray(gate, dtype=float).reshape(-1)
        gx, gy = gate[0], gate[1]
        gz = gate[2] if len(gate) > 2 and gate[2] > 0 else 1.0
        yaw = gate[5] if len(gate) > 5 else 0.0
        lat = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        corners = [
            [gx, gy, 0.0], [gx, gy, gz - half],  # post
        ]
        ax.plot(*np.array(corners).T, color="tab:orange", lw=2)
        ring = [
            np.array([gx, gy, gz]) + half * (c1 * lat + c2 * np.array([0, 0, 1]))
            for c1, c2 in [(-1, -1), (1, -1), (1, 1), (-1, 1), (-1, -1)]
        ]
        ax.plot(*np.array(ring).T, color="tab:orange", lw=2)

    # Obstacles: cylinders (r=0.05, h=1.05 — reference obstacle.urdf).
    th = np.linspace(0, 2 * np.pi, 20)
    for obs in obstacles or []:
        obs = np.asarray(obs, dtype=float).reshape(-1)
        ox, oy = obs[0], obs[1]
        ax.plot(ox + 0.05 * np.cos(th), oy + 0.05 * np.sin(th), 1.05, color="0.4")
        ax.plot([ox, ox], [oy, oy], [0, 1.05], color="0.4", lw=3)

    if trajectory is not None:
        tr = np.asarray(trajectory, dtype=float)
        ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], color="tab:green", lw=0.8, alpha=0.7)
    if goal is not None:
        gpt = np.asarray(goal, dtype=float).reshape(-1)
        ax.scatter([gpt[0]], [gpt[1]], [gpt[2]], color="tab:green", marker="*", s=80)

    ax.set_xlim(-2.5, 2.5)
    ax.set_ylim(-2.5, 2.5)
    ax.set_zlim(0, 2.5)
    ax.set_xlabel("x")
    ax.set_ylabel("y")


def draw_quadrotor_drone(ax, pos, rpy, arm_scale: float = 4.0):
    """Draw the drone (two motor arms in X config + heading tick) at
    ``pos``/``rpy``; returns the created line artists so a live viewer can
    remove and redraw them each frame."""
    arm = 0.0397 * arm_scale
    rot = _rot_xyz_np(*rpy)
    artists = []
    for d in (np.array([1, 1, 0]), np.array([1, -1, 0])):
        tip1 = pos + rot @ (arm * d / np.sqrt(2))
        tip2 = pos - rot @ (arm * d / np.sqrt(2))
        artists += ax.plot(*np.stack([tip1, tip2]).T, color="tab:blue", lw=2.5)
    nose = pos + rot @ np.array([2 * arm, 0, 0])
    artists += ax.plot(*np.stack([pos, nose]).T, color="tab:red", lw=1.5)
    return artists


def render_quadrotor(
    state_x,
    quad_type: int = 3,
    gates: Optional[Sequence] = None,
    obstacles: Optional[Sequence] = None,
    goal: Optional[np.ndarray] = None,
    trajectory: Optional[np.ndarray] = None,
    width: int = 640,
    height: int = 480,
    arm_scale: float = 4.0,
) -> np.ndarray:
    """Render one quadrotor state to an (H, W, 3) uint8 RGB frame.

    ``state_x`` is the env state vector (2, 6 or 12 dims per QuadType);
    ``gates`` rows are (x, y, z, r, p, yaw[, type]) apertures, ``obstacles``
    rows (x, y, z, ...) cylinder bases — the same layouts the env config
    carries (reference quadrotor.py:331-354).  Drawn by PIL
    (``raster_quadrotor``) where matplotlib is not installed.
    """
    pos, rpy = _pose_from_state(state_x, quad_type)
    if not have_matplotlib():
        return raster_quadrotor(pos, rpy, gates=gates, obstacles=obstacles, goal=goal,
                                trajectory=trajectory, width=width, height=height,
                                arm_scale=arm_scale)
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(width / 100, height / 100), dpi=100)
    ax = fig.add_subplot(projection="3d")
    draw_quadrotor_scene(ax, gates=gates, obstacles=obstacles, goal=goal,
                         trajectory=trajectory)
    draw_quadrotor_drone(ax, pos, rpy, arm_scale=arm_scale)
    return _fig_to_rgb(fig)


def render_cartpole(state_x, width: int = 640, height: int = 360,
                    pole_length: float = 0.5) -> np.ndarray:
    """Render one cartpole state [x, x_dot, theta, theta_dot] to RGB (by
    PIL, ``raster_cartpole``, where matplotlib is not installed)."""
    if not have_matplotlib():
        return raster_cartpole(state_x, width=width, height=height, pole_length=pole_length)
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    x = np.asarray(state_x, dtype=float).reshape(-1)
    cart_x, theta = x[0], x[2]
    fig, ax = plt.subplots(figsize=(width / 100, height / 100), dpi=100)
    ax.axhline(0.0, color="0.8")
    ax.add_patch(plt.Rectangle((cart_x - 0.15, -0.05), 0.3, 0.1, color="tab:blue"))
    tip = (cart_x + 2 * pole_length * np.sin(theta), 2 * pole_length * np.cos(theta))
    ax.plot([cart_x, tip[0]], [0.0, tip[1]], color="tab:red", lw=3)
    ax.set_xlim(cart_x - 2.5, cart_x + 2.5)
    ax.set_ylim(-1.2, 1.6)
    ax.set_aspect("equal")
    return _fig_to_rgb(fig)


# The PIL frames: an orthographic view of the maze's box x, y in
# [-2.5, 2.5], z in [0, 2.5] from azimuth -60 and elevation 30 degrees
# (matplotlib's default 3D view), z drawn 1.2x (its box aspect (1, 1, 0.6)).
_VIEW_AZIM, _VIEW_ELEV, _VIEW_Z = np.radians(-60.0), np.radians(30.0), 1.2
_RGB = {"grid": (217, 217, 217), "gate": (255, 127, 14), "obstacle": (102, 102, 102),
        "trajectory": (44, 160, 44), "drone": (31, 119, 180), "nose": (214, 39, 40)}


def _project(points):
    """World points (..., 3) -> view-plane coordinates (..., 2), up positive."""
    p = np.asarray(points, dtype=float) * np.array([1.0, 1.0, _VIEW_Z])
    ca, sa, ce, se = np.cos(_VIEW_AZIM), np.sin(_VIEW_AZIM), np.cos(_VIEW_ELEV), np.sin(_VIEW_ELEV)
    right = np.array([-sa, ca, 0.0])
    up = np.array([-se * ca, -se * sa, ce])
    return np.stack([p @ right, p @ up], -1)


def _canvas(width, height, lo, hi):
    """A white PIL canvas and the map from view-plane points to its pixels,
    fitting the box [lo, hi] (2-vectors) with a margin at one scale."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (int(width), int(height)), (255, 255, 255))
    scale = 0.9 * min(width / (hi[0] - lo[0]), height / (hi[1] - lo[1]))
    mid = (np.asarray(lo) + np.asarray(hi)) / 2

    def px(q):
        q = np.atleast_2d(q)
        return [(float(width / 2 + scale * (a - mid[0])), float(height / 2 - scale * (b - mid[1])))
                for a, b in q]

    return img, ImageDraw.Draw(img), px, scale


def _maze_canvas(width, height):
    view = _project([[x, y, z] for x in (-2.5, 2.5) for y in (-2.5, 2.5) for z in (0.0, 2.5)])
    return _canvas(width, height, view.min(0), view.max(0))


def raster_quadrotor(pos, rpy, gates=None, obstacles=None, goal=None, trajectory=None,
                     width: int = 640, height: int = 480, arm_scale: float = 4.0) -> np.ndarray:
    """The scene of ``render_quadrotor`` drawn by PIL: the ground grid, gates
    (post and square aperture), obstacles (post and top ring), the reference
    trajectory, the goal, and the drone's arms and heading, for a drone at
    ``pos`` with Euler angles ``rpy``."""
    img, draw, px, _ = _maze_canvas(width, height)

    def line(points, color, w=1):
        draw.line(px(_project(points)), fill=_RGB[color], width=w)

    g = np.linspace(-2.5, 2.5, 6)
    for v in g:
        line([[v, g[0], 0], [v, g[-1], 0]], "grid")
        line([[g[0], v, 0], [g[-1], v, 0]], "grid")
    half = 0.45 / 2
    for gate in gates or []:
        gate = np.asarray(gate, dtype=float).reshape(-1)
        gz = gate[2] if len(gate) > 2 and gate[2] > 0 else 1.0
        yaw = gate[5] if len(gate) > 5 else 0.0
        lat, centre = np.array([np.cos(yaw), np.sin(yaw), 0.0]), np.array([gate[0], gate[1], gz])
        line([[gate[0], gate[1], 0.0], [gate[0], gate[1], gz - half]], "gate", 2)
        line([centre + half * (c1 * lat + c2 * np.array([0, 0, 1.0]))
              for c1, c2 in [(-1, -1), (1, -1), (1, 1), (-1, 1), (-1, -1)]], "gate", 2)
    th = np.linspace(0, 2 * np.pi, 20)
    for obs in obstacles or []:
        ox, oy = np.asarray(obs, dtype=float).reshape(-1)[:2]
        line(np.stack([ox + 0.05 * np.cos(th), oy + 0.05 * np.sin(th), np.full(20, 1.05)], -1),
             "obstacle")
        line([[ox, oy, 0.0], [ox, oy, 1.05]], "obstacle", 3)
    if trajectory is not None:
        line(np.asarray(trajectory, dtype=float)[:, :3], "trajectory")
    if goal is not None:
        (gx, gy), = px(_project(np.asarray(goal, dtype=float).reshape(-1)[:3]))
        draw.regular_polygon((gx, gy, 6), 4, fill=_RGB["trajectory"])
    arm, rot = 0.0397 * arm_scale, _rot_xyz_np(*rpy)
    pos = np.asarray(pos, dtype=float)
    for d in (np.array([1, 1, 0]), np.array([1, -1, 0])):
        tip = rot @ (arm * d / np.sqrt(2))
        line([pos + tip, pos - tip], "drone", 3)
    line([pos, pos + rot @ np.array([2 * arm, 0, 0])], "nose", 2)
    return np.asarray(img, dtype=np.uint8)


def raster_cartpole(state_x, width: int = 640, height: int = 360,
                    pole_length: float = 0.5) -> np.ndarray:
    """The side view of ``render_cartpole`` drawn by PIL: the ground, the cart
    and the pole, over x in [cart - 2.5, cart + 2.5], y in [-1.2, 1.6]."""
    x = np.asarray(state_x, dtype=float).reshape(-1)
    cart_x, theta = x[0], x[2]
    img, draw, px, scale = _canvas(width, height, (cart_x - 2.5, -1.2), (cart_x + 2.5, 1.6))
    draw.line(px([[cart_x - 2.5, 0.0], [cart_x + 2.5, 0.0]]), fill=(204, 204, 204))
    draw.rectangle(px([[cart_x - 0.15, 0.05], [cart_x + 0.15, -0.05]]), fill=_RGB["drone"])
    tip = [cart_x + 2 * pole_length * np.sin(theta), 2 * pole_length * np.cos(theta)]
    draw.line(px([[cart_x, 0.0], tip]), fill=_RGB["nose"], width=max(int(0.03 * scale), 2))
    return np.asarray(img, dtype=np.uint8)


def save_video(frames: Sequence[np.ndarray], path: str, fps: int = 30) -> str:
    """Write frames to GIF (always) or MP4 (if ffmpeg is present).

    Counterpart of reference utils/utils.py:169 ``save_video``.  Returns the
    path actually written (MP4 requests fall back to GIF without ffmpeg).
    """
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    if not frames:
        raise ValueError("save_video: no frames captured (did you call capture()?)")
    if path.endswith(".mp4"):
        try:
            import matplotlib.animation as manim

            if manim.FFMpegWriter.isAvailable():
                import matplotlib.pyplot as plt

                h, w = frames[0].shape[:2]
                fig = plt.figure(figsize=(w / 100, h / 100), dpi=100)
                ax = fig.add_axes([0, 0, 1, 1])
                ax.axis("off")
                im = ax.imshow(frames[0])
                writer = manim.FFMpegWriter(fps=fps)
                with writer.saving(fig, path, dpi=100):
                    for f in frames:
                        im.set_data(f)
                        writer.grab_frame()
                plt.close(fig)
                return path
        except Exception:
            pass
        path = path[:-4] + ".gif"
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=max(int(1000 / fps), 1), loop=0,
    )
    return path


class FrameRecorder:
    """Collects frames during a host-side episode loop and saves a video.

    Mirrors BaseAviary's RECORD path (base_aviary.py:324-360) as an explicit
    host-side utility: call ``capture(state_x)`` at whatever cadence you
    like, then ``save(path)``.
    """

    def __init__(self, env=None, every: int = 1, **render_kwargs):
        self.every = max(int(every), 1)
        self.frames = []
        self._count = 0
        self._kwargs = dict(render_kwargs)
        if env is not None:
            cfg = env.config
            self._kwargs.setdefault("quad_type", int(getattr(cfg, "quad_type", 3)))
            if getattr(cfg, "gates", None):
                self._kwargs.setdefault("gates", list(cfg.gates))
            if getattr(cfg, "obstacles", None):
                self._kwargs.setdefault("obstacles", list(cfg.obstacles))
            xg = np.asarray(env.x_goal)
            if xg.ndim == 2 and xg.shape[1] >= 6:
                self._kwargs.setdefault("trajectory", xg[:, [0, 2, 4]])

    def capture(self, state_x):
        if self._count % self.every == 0:
            self.frames.append(render_quadrotor(np.asarray(state_x), **self._kwargs))
        self._count += 1

    def save(self, path: str, fps: int = 30) -> str:
        return save_video(self.frames, path, fps=fps)
