"""The port's renderer (``utils/rendering.py``), live viewer
(``utils/viewer.py``), ``GymEnv.render`` and ``getting_started.run(gui=True)``
against the JAX package's, on the CPU.

The frames are drawn on the host by the same matplotlib code in both
packages, so from the same state they are held equal pixel for pixel: the
twins of tests/test_rendering.py's cases, and ``render()`` of the two gym
adapters from the JAX adapter's state (carried by utils/convert).  The
viewer records on a host without a display, as the JAX viewer does, and a
short level-0 sim-only flight with ``gui=True`` writes its gif.  Where
matplotlib is not installed the port draws its frames with PIL
(``raster_quadrotor``, ``raster_cartpole``): the same layout, the drone at
its projected pixel, one frame a state."""

import os
import time

import jax
import numpy as np
import pytest
import yaml

from safe_control_gym_torch.competition import getting_started as tg
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import gym_adapter as tga
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.utils import rendering as tr
from safe_control_gym_torch.utils import viewer as tv
from safe_control_gym_torch.utils.convert import cartpole_state_from_numpy, quad_state_from_numpy
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.envs import gym_adapter as jga
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.utils import rendering as jr
from safe_control_gym_tpu.utils import viewer as jv

GATES = [[0.5, -1.0, 0, 0, 0, 0.8, 0]]
OBSTACLES = [[1.5, 0.0, 0, 0, 0, 0]]
LEVELS = os.path.join(os.path.dirname(__file__), "..", "safe_control_gym_tpu", "competition",
                      "levels")


def hover(x0=0.0):
    x = np.zeros(12)
    x[0], x[4] = x0, 1.0
    return x


def test_render_quadrotor_frame():
    kw = dict(gates=GATES, obstacles=OBSTACLES, goal=np.array([2.0, 1.0, 1.0]), width=320,
              height=240)
    frame = tr.render_quadrotor(hover(), **kw)
    assert frame.shape == (240, 320, 3) and frame.dtype == np.uint8
    assert int((frame < 250).any(-1).sum()) > 1000  # the scene is drawn
    np.testing.assert_array_equal(frame, jr.render_quadrotor(hover(), **kw))


@pytest.mark.parametrize("quad_type, x", [(1, [1.2, 0.0]), (2, [0.1, 0, 1.0, 0, 0, 0.2])])
def test_render_quad_types(quad_type, x):
    frame = tr.render_quadrotor(x, quad_type=quad_type, width=160, height=120)
    assert frame.shape == (120, 160, 3)
    np.testing.assert_array_equal(
        frame, jr.render_quadrotor(x, quad_type=quad_type, width=160, height=120))


def test_render_cartpole_frame():
    x = [0.3, 0.0, 0.4, 0.0]
    frame = tr.render_cartpole(x, width=320, height=180)
    assert frame.shape == (180, 320, 3) and int((frame < 250).any(-1).sum()) > 200
    np.testing.assert_array_equal(frame, jr.render_cartpole(x, width=320, height=180))


def test_video_and_recorder(tmp_path):
    rec, jrec = tr.FrameRecorder(every=2, width=160, height=120), jr.FrameRecorder(
        every=2, width=160, height=120)
    for i in range(6):
        rec.capture(hover(0.1 * i))
        jrec.capture(hover(0.1 * i))
    assert len(rec.frames) == len(jrec.frames) == 3
    for a, b in zip(rec.frames, jrec.frames):
        np.testing.assert_array_equal(a, b)
    out = rec.save(str(tmp_path / "ep.gif"), fps=5)
    assert os.path.exists(out) and os.path.getsize(out) > 0
    # An MP4 request writes a GIF where ffmpeg is absent.
    out2 = tr.save_video(rec.frames, str(tmp_path / "ep2.mp4"), fps=5)
    assert os.path.exists(out2)
    assert out2 == jr.save_video(jrec.frames, str(tmp_path / "jep2.mp4"), fps=5).replace(
        "jep2", "ep2")


@pytest.mark.parametrize("family", ["quadrotor", "cartpole"])
def test_pil_frames_where_matplotlib_is_missing(family, monkeypatch):
    """Without matplotlib the frames are PIL's: the same (H, W, 3) uint8
    layout, the scene drawn, the drone (the pole) where the state puts it,
    and the same frame from the same state."""
    monkeypatch.setattr(tr, "have_matplotlib", lambda: False)
    if family == "quadrotor":
        kw = dict(gates=GATES, obstacles=OBSTACLES, goal=np.array([2.0, 1.0, 1.0]),
                  trajectory=np.stack([np.linspace(-1, 1, 30), np.zeros(30), np.ones(30)], -1))
        frames = [tr.render_quadrotor(hover(x0), **kw) for x0 in (0.0, 0.0, 1.0)]
        want = tr.raster_quadrotor(np.array([0.0, 0.0, 1.0]), np.zeros(3), **kw)
        assert frames[0].shape == (480, 640, 3)
        blue = np.all(frames[0] == tr._RGB["drone"], -1)
        (u, v), = tr._maze_canvas(640, 480)[2](tr._project([0.0, 0.0, 1.0]))
        ys, xs = np.nonzero(blue)
        assert abs(xs.mean() - u) < 4 and abs(ys.mean() - v) < 4  # the drone at its pixel
    else:
        frames = [tr.render_cartpole(x, width=320, height=180) for x in
                  ([0.3, 0, 0.4, 0], [0.3, 0, 0.4, 0], [0.3, 0, -0.4, 0])]
        want = tr.raster_cartpole([0.3, 0, 0.4, 0], width=320, height=180)
        assert frames[0].shape == (180, 320, 3)
    assert frames[0].dtype == np.uint8 and int((frames[0] < 250).any(-1).sum()) > 300
    np.testing.assert_array_equal(frames[0], frames[1])
    np.testing.assert_array_equal(frames[0], want)
    assert not np.array_equal(frames[0], frames[2])


def test_live_viewer_records_pil_frames_where_matplotlib_is_missing(tmp_path, monkeypatch):
    monkeypatch.setattr(tr, "have_matplotlib", lambda: False)
    v = tv.LiveViewer(every=1, gates=GATES, goal=np.array([1, 1, 1.0]))
    for i in range(3):
        v.update(hover(0.2 * i), t=i * 0.04)
    assert len(v.frames) == 3 and v.frames[0].shape == (480, 640, 3)
    out = v.close(save_path=str(tmp_path / "live.gif"), fps=10)
    assert os.path.getsize(out) > 0


def test_live_viewer_headless_fallback(tmp_path):
    """Without a window the viewer records every ``every``-th update and
    writes them; ``sync`` sleeps toward the wall-clock schedule."""
    scene = dict(gates=GATES, goal=np.array([1, 1, 1.0]))
    v = tv.LiveViewer(interactive=False, every=2, **scene)
    jview = jv.LiveViewer(interactive=False, every=2, **scene)
    assert not v.interactive
    for i in range(4):
        x = hover(0.2 * i)
        v.update(x, t=i * 0.04, reward=0.5)
        jview.update(x, t=i * 0.04, reward=0.5)
    assert len(v.frames) == len(jview.frames) == 2
    for a, b in zip(v.frames, jview.frames):
        np.testing.assert_array_equal(a, b)
    out = v.close(save_path=str(tmp_path / "live.gif"), fps=10)
    assert out and os.path.exists(out) and os.path.getsize(out) > 0
    assert v.close() is None  # nothing more to write

    t0 = time.time() - 0.01
    tv.sync(2, t0, 0.02)  # due at t0 + 0.04: ~30 ms of sleep
    assert time.time() - t0 >= 0.04


def test_viewer_env_scene_pickup():
    """The viewer takes the maze and the reference from a port env as the
    JAX viewer does from a JAX env."""
    cfg = dict(quad_type=3, task="traj_tracking", gates=[[0.5, -2.5, 0, 0, 0, -1.57, 0]],
               obstacles=[[1.5, -2.5, 0, 0, 0, 0]])
    v = tv.LiveViewer(env=tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"),
                      interactive=False)
    jview = jv.LiveViewer(env=jq.make_quadrotor(jq.QuadrotorConfig(**cfg)), interactive=False)
    assert v._scene.get("gates") and v._scene.get("obstacles")
    assert sorted(v._scene) == sorted(jview._scene)
    np.testing.assert_array_equal(v._scene["trajectory"], jview._scene["trajectory"])
    v.update(np.zeros(12))
    jview.update(np.zeros(12))
    assert len(v.frames) == 1
    np.testing.assert_array_equal(v.frames[0], jview.frames[0])
    v.close()


def _fields(state):
    return jax.tree.map(lambda a: np.asarray(a)[None],
                        {k: getattr(state, k) for k in state.__dataclass_fields__ if k != "key"})


CART = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=0.2, task="stabilization",
            randomized_init=True, randomized_inertial_prop=True)
QUAD = dict(quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=1, task="stabilization",
            task_info={"stabilization_goal": [0, 0, 1], "stabilization_goal_tolerance": 0.05},
            cost="rl_reward", randomized_init=True, gates=GATES, obstacles=OBSTACLES)


@pytest.mark.parametrize("family", ["cartpole", "quadrotor"])
def test_gym_render_matches_jax(family):
    """``GymEnv.render()`` from the JAX adapter's state, after reset and
    after two steps: CartPole with the state's randomized pole length, the
    quadrotor with its goal, gates and obstacles."""
    if family == "cartpole":
        jenv = jga.GymEnv(jc.make_cartpole(jc.CartPoleConfig(**CART)), seed=5)
        tenv = tga.GymEnv(tc.make_cartpole(tc.CartPoleConfig(**CART), device="cpu"), seed=5)
        convert = cartpole_state_from_numpy
    else:
        jenv = jga.GymEnv(jq.make_quadrotor(jq.QuadrotorConfig(**QUAD, use_pallas=False)), seed=5)
        tenv = tga.GymEnv(tq.make_quadrotor(tq.QuadrotorConfig(**QUAD), device="cpu"), seed=5)
        convert = quad_state_from_numpy
    jenv.reset()
    tenv.reset()
    tenv._state = convert(_fields(jenv.state), "cpu")
    for _ in range(3):
        frame = tenv.render()
        assert frame.ndim == 3 and frame.shape[-1] == 3 and frame.dtype == np.uint8
        np.testing.assert_array_equal(frame, jenv.render())
        a = np.full(jenv.action_space.shape, 0.1, np.float32)
        jenv.step(a)
        tenv.step(a)
        tenv._state = convert(_fields(jenv.state), "cpu")


def test_getting_started_gui_writes_its_gif(tmp_path, monkeypatch):
    """``run(gui=True)`` on level 0's sim-only path with a short episode: no
    display here, so the viewer records every ``gui_every``-th step and the
    episode's gif lands in the working directory."""
    with open(os.path.join(LEVELS, "level0.yaml")) as f:
        level = yaml.safe_load(f)["quadrotor_config"]
    level["episode_len_sec"] = 0.5
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    frames = []
    real = tv.LiveViewer

    class Counting(real):
        def close(self, *a, **k):
            frames.append(len(self.frames))
            return super().close(*a, **k)

    monkeypatch.setattr(tg, "LiveViewer", Counting)
    stats = tg.run(level, num_episodes=1, use_firmware=False, ctrl_freq=60, gui=True,
                   gui_every=3, device="cpu")
    steps = stats[0]["steps"]
    assert steps == 30 and frames == [-(-steps // 3)]
    gif = tmp_path / "gui_episode0.gif"
    assert gif.exists() and gif.stat().st_size > 0
