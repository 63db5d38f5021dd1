"""The BASELINE configs of ``bench.py`` in the port's config classes.

One place for the workloads that ``scripts/bench_port.py`` times and
``chip_smoke.py`` drives: config 2 (CartPole tracking), config 3 (2D
quadrotor stabilization), config 4 (3D quadrotor figure-8 tracking), config
5 (the level-2 competition maze), and the two stabilization tasks that PPO
trains on (``benchmarks/rl_convergence.py``), and the MPC solve workload of
``benchmarks/mpc_solve.py``.  Each function takes keyword
overrides of the config's fields.
"""

from __future__ import annotations

from safe_control_gym_torch.envs.cartpole import CartPoleConfig
from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig

# Level-2 gate poses [x, y, z, r, p, yaw, type] and obstacle poses
# (bench.py:160-171).
LEVEL2_GATES = (
    [0.5, -2.5, 0, 0, 0, -1.57, 0],
    [2.0, -1.5, 0, 0, 0, 0, 1],
    [0.0, 0.2, 0, 0, 0, 1.57, 1],
    [-0.5, 1.5, 0, 0, 0, 0, 0],
)
LEVEL2_OBSTACLES = (
    [1.5, -2.5, 0, 0, 0, 0],
    [0.5, -1.0, 0, 0, 0, 0],
    [1.5, 0.0, 0, 0, 0, 0],
    [-1.0, 0.0, 0, 0, 0, 0],
)
STATE_BOX = ({"constraint_form": "default_constraint", "constrained_variable": "state"},)
INPUT_BOX = ({"constraint_form": "default_constraint", "constrained_variable": "input"},)


def cfg4(**kw) -> QuadrotorConfig:
    """BASELINE config 4 (bench.py:70-112): 3D quadrotor figure-8 tracking,
    box state and input constraints, an impulse dynamics disturbance,
    randomized inertia and initial state, out-of-bound done."""
    base = dict(
        quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=6,
        task="traj_tracking",
        task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
                   "trajectory_position_offset": [0.0, 0.0], "trajectory_scale": 1.0,
                   "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
        cost="rl_reward", randomized_inertial_prop=True, randomized_init=True,
        constraints=STATE_BOX + INPUT_BOX,
        disturbances={"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.005,
                                    "duration": 10, "decay_rate": 0.8},)},
        done_on_out_of_bound=True,
    )
    base.update(kw)
    return QuadrotorConfig(**base)


def cfg5(**kw) -> QuadrotorConfig:
    """BASELINE config 5 (bench.py:147-210): the level-2 competition maze, 4
    randomized gates and 4 randomized obstacles, the competition cost, the
    default state constraint, collision done, no out-of-bound done, action
    white noise of std 0.001 and a uniform dynamics force of +-0.1 N,
    randomized inertia and initial state; 30 Hz control, 60 Hz physics, 15 s
    episodes."""
    base = dict(
        quad_type=3, ctrl_freq=30, pyb_freq=60, episode_len_sec=15,
        task="stabilization",
        task_info={"stabilization_goal": [-0.5, 2.9, 0.75],
                   "stabilization_goal_tolerance": 0.15},
        cost="competition",
        gates=LEVEL2_GATES, obstacles=LEVEL2_OBSTACLES,
        randomized_gates_and_obstacles=True,
        randomized_init=True,
        randomized_inertial_prop=True,
        constraints=STATE_BOX,
        disturbances={
            "action": ({"disturbance_func": "white_noise", "std": 0.001},),
            "dynamics": ({"disturbance_func": "uniform", "low": [-0.1] * 3, "high": [0.1] * 3},),
        },
        done_on_collision=True,
        done_on_out_of_bound=False,
    )
    base.update(kw)
    return QuadrotorConfig(**base)


def cfg_cartpole(**kw) -> CartPoleConfig:
    """BASELINE config 2 (bench.py:226-260): CartPole tracking, box state and
    input constraints, action white noise of std 0.2, out-of-bound done."""
    base = dict(
        ctrl_freq=50, pyb_freq=50, episode_len_sec=10, task="traj_tracking", randomized_init=True,
        constraints=STATE_BOX + INPUT_BOX,
        disturbances={"action": ({"disturbance_func": "white_noise", "std": 0.2},)},
        done_on_out_of_bound=True,
    )
    base.update(kw)
    return CartPoleConfig(**base)


def cfg_quad2d(**kw) -> QuadrotorConfig:
    """BASELINE config 3 (bench.py:275-308): 2D quadrotor stabilization at
    [0, 1], randomized inertia and initial state, state box, out-of-bound
    done."""
    base = dict(
        quad_type=2, ctrl_freq=50, pyb_freq=200, episode_len_sec=10, task="stabilization",
        task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.05},
        randomized_init=True, randomized_inertial_prop=True,
        constraints=STATE_BOX,
        done_on_out_of_bound=True,
    )
    base.update(kw)
    return QuadrotorConfig(**base)


def cfg_cartpole_rl(**kw) -> CartPoleConfig:
    """cartpole_stab (benchmarks/rl_convergence.py:34-41)."""
    base = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=5.0, task="stabilization",
                cost="rl_reward", randomized_init=True, normalized_rl_action_space=True)
    base.update(kw)
    return CartPoleConfig(**base)


def cfg_quad2d_rl(**kw) -> QuadrotorConfig:
    """quad2d_stab_reference_task (benchmarks/rl_convergence.py:44-54)."""
    base = dict(quad_type=2, ctrl_freq=60, pyb_freq=240, episode_len_sec=5, task="stabilization",
                cost="rl_reward", randomized_init=True, normalized_rl_action_space=True)
    base.update(kw)
    return QuadrotorConfig(**base)


def cfg_mpc_solve(**kw) -> QuadrotorConfig:
    """The MPC solve workload of ``benchmarks/mpc_solve.py:31-42``: 2D
    quadrotor stabilization to (0.5, 1.0), the input box."""
    base = dict(
        quad_type=2, ctrl_freq=50, pyb_freq=50, episode_len_sec=5, task="stabilization",
        task_info={"stabilization_goal": [0.5, 1.0], "stabilization_goal_tolerance": 0.05},
        cost="quadratic", constraints=INPUT_BOX,
    )
    base.update(kw)
    return QuadrotorConfig(**base)


def cfg_rl_figure8(**kw) -> QuadrotorConfig:
    """The env of ``benchmarks/rl_throughput.py`` and ``rl_equivalence.py``:
    config 4's figure-8 task with the normalized action space and randomized
    inertia, and nothing else (no constraints, disturbance or random
    initial state)."""
    base = dict(
        quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=6, task="traj_tracking",
        task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
                   "trajectory_position_offset": [0, 0], "trajectory_scale": 1.0,
                   "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
        cost="rl_reward", normalized_rl_action_space=True, randomized_inertial_prop=True,
    )
    base.update(kw)
    return QuadrotorConfig(**base)
