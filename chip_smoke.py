#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``safe_control_gym_torch``).

Drives the port's paths on one CUDA card: BASELINE config 4 (3D quadrotor,
figure-8 tracking, box constraints, impulse disturbance, randomized inertia
and initial state, out-of-bound done, masked auto-reset), config 5 (the
level-2 competition maze: 4 randomized gates and obstacles, the
competition cost, collision done, action white noise and a uniform
dynamics force), config 2 (CartPole tracking with box constraints and
action white noise), config 3 (2D quadrotor stabilization with randomized
mass and inertia), and PPO training on config 4, CartPole stabilization and
quad-2D stabilization, with the observation branches of K3, K6 and K8 on
config 4-GH and the planar and CartPole tasks with goal rows and
observation noise (the configs: ``safe_control_gym_torch/baseline.py``,
``cfg4_gh`` and ``cfg_quad2d_gh`` here):

1. builds the kernels (K1-K8) from ``safe_control_gym_torch/csrc`` and
   prints the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
2. holds K1 (``quad3d_substeps``) against its plain PyTorch version bit
   for bit on random states, float32 and float64, RK4 and Euler, actuation
   on and off, at every group of lanes per env the source builds at
   B = 1000 (ragged) and 4096, and with the launch plan's group at the
   batches where the plan changes group; K1's float64 instance against
   its plain version at B = 4096 (1e-12); a float64 3D env steps on the
   card through that instance (one launch a step), within 1e-10 of the
   same env on the CPU, and a float32 env launches K1's float32 instance;
2b. builds the native runtime (``safe_control_gym_torch/native``, host
   C++) with g++ and loads it, never its NumPy fallback (``phase_native``);
   flies tests/test_native.py's 3D quad in float64 on the card at B = 4096
   for 40 steps, each env under its own seeded thrusts (K1's float64
   instance once a step), and holds every trajectory against the C++
   oracle on the host at rtol 1e-9 / atol 1e-10; the compiled oracle
   against its NumPy fallback; env 0's flight through the ring-buffer
   flight logger, bit for bit, and back from its CSV;
3. holds K2 (``quad3d_rollout``) against its plain version at B = 1024 and
   at the ragged B = 1000 (the last block's groups partly past the last
   env) for CHECK_STEPS steps with auto-resets: all rows, done counts
   exactly;
4. holds K2 against the port's general engine (which runs K1) over the same
   steps and env seeds;
4b. holds K2's maze instance (config 5, 4 s episodes, step noise on)
   against its plain version bit for bit, every row, at B = 1000 and 4096
   over MAZE_CHECK_STEPS steps through collision resets and pose redraws;
   and one step of it from 1024 scattered states (some placed in their
   current gate's aperture and some at the goal, one step from completion;
   noise off) against the general engine: done exact, reward atol 1e-4, the
   states of the envs not done rtol 2e-4 / atol 2e-5, their maze counters
   exact, 0.5-90% done;
5. times config 4's serving path at B = 4096: the general engine for
   GENERAL_STEPS hover steps and the whole-rollout engine for one call of 8192 steps,
   after two warm-ups, with launch counters zeroed just before and read just
   after; holds K2 against its plain version on a PLAIN_STEPS-step call
   from the timed call's own rows, and K1 on the general engine's own inputs; times
   each kernel alone (K1 by the profiler's device time, and its share of
   the general engine's device time; the others, whose
   launches take milliseconds, by CUDA events around back-to-back launches,
   since torch.profiler was seen to drop kernel events after the plain
   versions' many small launches) and the plain versions (no yardstick of speed: they
   repeat the kernels' arithmetic op by op);
6. holds K3 (``quad3d_policy_rollout``, the PPO data collection) against
   its plain version at B = 1024 and 1000 for CHECK_STEPS steps through
   auto-resets,
   at hidden width 64 and 128 (the run-time-width instance): all rows and
   the whole record, done counts exactly;
6b. drives K3's maze instances (``phase_k3_maze``): ``FastPolicyRollout`` on
   config 5 with the normalized action space at B = 4096, T = 128, H = 64
   and 128, seeded weights, one call through ``run`` with the launch
   counters zeroed just before and read just after, rows and record bit for
   bit against the plain version, its auto-resets and truncations counted
   and the call timed; then at B = 1000 and 1024, with observation noise
   and with goal rows (the maze's observation instance), bit for bit; and
   one step on config 5 without noise under a logstd of -20 against the
   general engine driven by the policy's means (done exact, reward 1e-4,
   live states 2e-4 / 2e-5, gate counters exact, the placed envs through
   their gate); prints the SASS size of K3's instances (config 4's, config
   4-GH's observation instance, the maze instance);
6c. drives the env surface (``phase_env_surface``): the general engine at
   B = 4096 for 32 steps on config 4 with the aero modes (no K1 launch)
   and on config 4 with a quadratic constraint, a periodic dynamics force
   and the adversary channel (K1 once a step), each against the same run on
   the CPU (states 2e-4 / 2e-5, done flags exact every step), with its host
   ms a step;
7. holds K4 (``ppo_grads``, the PPO minibatch gradients) against its plain
   version and against ``torch.autograd`` of the reference losses at
   mb = 131072, tanh, at the config-4 (nx 12, nu 4), CartPole (4, 1) and
   quad-2D (6, 2) shapes with H = 64, config 4 with H = 128 and (128, 8)
   with H = 64 and 256, two K4 launches against each other bit for bit, and
   times K4 and its plain version at each shape;
8. holds K5 (``cartpole_rollout``) and K6 (``cartpole_policy_rollout``), K7
   (``quad_planar_rollout``, 1D and 2D) and K8
   (``quad_planar_policy_rollout``, 1D and 2D) against their plain versions
   at B = 1024 for CHECK_STEPS steps through auto-resets (all four, one env over a
   group of lanes, also at the ragged B = 1000 and at the batches where
   their launch plans pick their other group sizes, K7 there with and
   without action noise; K6 and K8 at H = 64 and 128, at every group they
   are built for, on the rl configs and on the circle with action white
   noise and an impulse), and K5 and K7 against the port's general engine;
8b. holds the policy kernels' observation instances (observation white
   noise of std 0.05, goal-horizon rows) against their plain versions at
   B = 1024 and 1000, H = 64 and 128, CHECK_STEPS steps through resets and
   truncations: K3 on config 4-GH (config 4 with two goal-horizon blocks,
   obs 36: ``cfg4_gh``), K8 on 2D stabilization and 2D tracking with two
   goal-horizon blocks, K6 on CartPole stabilization; and under a
   zero-weight policy bit for bit, with and without the noise;
9. serves config 5, config 2 and config 3 at B = 4096: the general engine
   (``make_cartpole`` / ``make_quadrotor`` + ``make_vec_env`` + ``rollout``)
   for 64 steps (config 5's runs K1 once a step), then one K2 call of 8192
   steps (the maze instance), one K5 call of 8192 steps and one K7 call of
   4096 steps, timed after two warm-ups with the launch counters zeroed just
   before and read just after; K2's maze instance, K5 and K7 against their
   plain versions on a call from the timed call's own rows (K2: every row
   bit for bit);
10. drives the training paths, PPO at the ``rl_train`` shapes (B = 4096,
   T = 128, 10 epochs of 4 minibatches of 131072) on config 4, config 4-GH
   (K3's observation instance, K4 at obs 36), CartPole stabilization and
   quad-2D stabilization at H = 64, and config 4 at H = 128, normalized
   action space: two warm-up train steps, then 3 timed train steps with the
   launch counters zeroed just before and read just after (K3, K6 or K8
   once and K4 forty times per train step); quad-2D stabilization with two
   goal-horizon blocks and the noise (K8's observation instance) and
   CartPole stabilization with the noise (K6's), one warm-up and one timed
   step each; the device busy share and the kernels that take the time,
   from a profiled train step whose session recorded both the policy
   kernel and K4 (up to TRAIN_PROFILE_SESSIONS sessions, else the run
   fails); the policy kernel against its plain version on the timed call's
   own input, and timed alone;
10b. drives the model-based base (``phase_lqr``, ``phase_pid``): LQR on
   config 4 at B = 4096 (the tracking gain table, one Riccati solve a
   waypoint, built on the card against the CPU; three waypoints' float64
   DARE against scipy; one full run_tracking episode on the general engine,
   K1 once a step, its host ms a step, RMSE and profile; 32 closed-loop steps
   against the CPU), LQR's run(analysis=True) on CartPole stabilization at
   B = 4096 (every env at the goal, env 0's state RMSE against the CPU), and
   the batched PID on B = 4096 3D quadrotors for a whole episode
   (tests/test_controllers.py:82-99: every env within 0.1 m of the goal, K1
   once a step) with one pid_control step against the CPU;
10c. PPO's leftovers (``phase_ppo_extras``): config 4 at the rl_train shapes
   with the fused 2H-wide update against the separate autograd update (the
   parameters within rtol 2e-4), and the CNN, the masked RNN and the
   Categorical on the card against the CPU;
10d. the model-based stack (``phase_mpc_solve``, ``phase_mpc``,
   ``phase_ilqr``, ``phase_linear_mpc``, ``phase_gp_mpc``, ``phase_cbf``):
   the benchmarks/mpc_solve.py workload (2D quad, B = 1024, H = 20) as one
   batched AL-iLQR solve under ``set_sync_debug_mode("error")``, against
   the CPU on 8 envs, its launches (profiler) and ms, a single solve's ms;
   MPC on B = 1024 3D quads for 50 closed-loop steps through the general
   engine (K1 once a step; the bar at step 50: median position error <=
   0.45 m and <= 0.65 of its value after the first step; the first 3
   solves of 32 envs against the CPU);
   iLQR's learn() on CartPole against the CPU and its episode's bar, with
   the backward pass's eigh cost; LinearMPC on 256 2D quads to its bar;
   GP-MPC's learn(), margins and the solves of 10 closed-loop steps against
   the CPU; the CBF filter's certify on 4096 states against the CPU and
   is_cbf;
10e. the firmware and the competition stack (``phase_firmware``,
   ``phase_competition_sim_only``, ``phase_competition``): the fused
   firmware block against the host loop over tests/test_firmware.py's
   60-step script (K1 20 times a control step), one block under
   ``set_sync_debug_mode("error")``, its device operations and host ms;
   ``getting_started.run`` on level 0 sim-only at 60 Hz (4 gates, 0
   collisions, reward > 300; K1 once a step) and on level 2, seed 2, with
   the default stack (firmware, MPCC) cut to 2.5 s (no collision, no early
   done, K1 launches = ticks executed), its ms a block and a solve (cold
   and warm) and a solve's launches; K1 at B = 1 bit for bit on the
   flight's own inputs, its device time and an empty kernel's (the launch
   floor);
10f. the other learners and sim2real (``phase_learners``,
   ``phase_sim2real``): SAC and DDPG on config 4 at the registry's widths
   (hidden 256, B = 4, train_interval 100, batch 64, a buffer of 1e6; the
   warm-up cut to 200 env steps), four timed train steps each with K1
   once an env step (25 a train step) and nothing else, one under
   ``set_sync_debug_mode("error")``, one profiled (device operations and
   busy share), K1 at B = 4 bit for bit on the path's own inputs with its
   device time and the launch floor; a RARL and a RAP cycle on config 4
   with the adversary on the dynamics (K1 200 a cycle); SafeExplorerPPO's
   pretrain and a train step on config 4 (K1 100, K4 60 at mb = 64, two of
   its minibatches against the plain version, K4's device time a call and
   the launch floor); tests/test_rl.py's SAC learning bar on CartPole (80
   train steps of 10 updates: r1 > r0); ``fit_quad3d_params`` on
   tests/test_sim2real.py's synthetic flight over 4096 candidates (K1 120
   launches without actuation, the test's bars, K1 at B = 4096 bit for
   bit on the fit's inputs);
10g. the experiment workflow (``phase_experiment``): config 4 at the
   rl_train shapes through ``ConfigFactory``, ``set_dir_from_config`` and the
   registry's ``make``: a train step bit for bit against phase_train's
   directly built PPO (K3 once, K4 forty times each; the same device
   operations by ``profile_launches``; the walls in turns), three train
   steps under ``utils/profiling.device_trace`` logged by
   ``ExperimentLogger`` and metered by ``ThroughputMeter``, whose
   ``summarize_kernels`` sees K3 3 and K4 120 times; fault (g): 2 train
   steps, ``save``, ``load`` into a fresh PPO, 1 more, bit for bit against
   3 uninterrupted; ``ppo.run`` over 4096 episodes (K1 once a step and
   nothing else); ``GymEnv.render`` of config 4 on the card against the
   CPU env's frame from the same state; ``getting_started.run`` on level 0,
   sim-only, with ``gui=True`` cut to 0.5 s, recording its gif;
10h. the distributed path (``phase_distributed``): (a) a one-rank NCCL
   group in this process: config 4's sharded rollout at B = 4096 for
   GENERAL_STEPS steps (K1 once a step) against the unsharded rollout, every env's state
   bit for bit and the statistics equal, the walls in turns; one sharded PPO
   train step at the rl_train shapes (K4 forty times) against
   ``_train_step`` with the same sample normals and permutations, the
   parameters and Adam moments bit for bit; an NCCL all-reduce of K4's
   gradients timed; the validation worker at B = 4096; the group destroyed.
   (b) two gloo ranks sharing the card (``launch_workers(..., device="cuda")``):
   ``dryrun_multichip(2)`` at 1024 envs a rank (the sharded PPO step; K2
   under the group bit for bit against the same calls in turn; K4's
   all-reduced gradients against the sequential sum, 2e-5) and the
   validation worker at B = 4096, whose statistics equal (a)'s (episodes
   exactly, means rtol 1e-5);
11. prints each kernel's registers and spills (``ptxas -v``), each phase's
   seconds, one JSON line of per-kernel results (K1 with its plan's group
   and block and every instance's registers and spill bytes; K2 with its
   maze instance's time, bound, registers and spill bytes; the observation
   instances of K3, K6 and K8 and K3's maze instance as entries of their
   own), then the final status line.

Any failure raises and exits non-zero; nothing falls back to the CPU.

    python3 chip_smoke.py [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# The BASELINE configs, defined once for this script and scripts/bench_port.py.
from safe_control_gym_torch.baseline import (
    cfg4, cfg5, cfg_cartpole, cfg_cartpole_rl, cfg_quad2d, cfg_quad2d_rl)

ROOT = os.path.dirname(os.path.abspath(__file__))
B_MAIN = 4096
GENERAL_STEPS = 128
FAST_STEPS = 8192
# The kernels' checks against their plain versions run CHECK_STEPS steps of
# 0.2-s episodes (10 or 12 steps at 50 or 60 Hz): through the first auto-reset
# and truncation and two or more steps of the next episode.
CHECK_B, CHECK_STEPS = 1024, 14
# K2 and K3 also at a batch that leaves the last block's lane groups partly
# past the last env.
RAGGED_B = 1000
# The whole-rollout kernels against their plain versions on a call of this
# many steps from the timed call's own rows (the plain versions launch
# thousands of small PyTorch ops per step: 40-80 ms a step at B = 4096).
PLAIN_STEPS = 256
# K2's maze instance against its plain version: steps through collision
# resets and pose redraws, and the steps of the call from the timed call's
# rows; the one-step cross-check's batch.
MAZE_CHECK_STEPS, MAZE_PLAIN_STEPS, MAZE_CROSS_B = 40, 128, 1024
# tests/test_fast_maze.py's spawns, scattered over the arena.
MAZE_SCATTER = {"init_x": {"distrib": "uniform", "low": -2.0, "high": 2.0},
                "init_y": {"distrib": "uniform", "low": -2.5, "high": 2.0},
                "init_z": {"distrib": "uniform", "low": 0.1, "high": 1.4}}
CP_FAST_STEPS, Q2_FAST_STEPS = 8192, 4096  # one K5 call (config 2), one K7 call (config 3)
SERVE_GENERAL_STEPS = 64  # general-engine steps of the config 2 and 3 serving paths
# Row layouts for a whole-rollout kernel's check against its plain version:
# rows held exactly (step, offset, done count, episode index), the done-count
# row, the seed row (a bit pattern), and the float rows (what, rows, rtol,
# atol).  The states and statistics take the JAX suite's tolerances; mass
# and inertia (~1e-5 in size for the quadrotors) are compared relatively,
# as the JAX comparison does.
K2_EXACT_ROWS = [16, 17, 21, 26]
K2_CLOSE_ROWS = (("states", slice(0, 12), 2e-4, 2e-5),
                 ("mass and inertia", slice(12, 16), 1e-6, 0.0),
                 ("statistics", slice(18, 25), 2e-4, 1e-5))
K2_LAYOUT = dict(exact=K2_EXACT_ROWS, done=21, seed=25, close=K2_CLOSE_ROWS)
# K2's maze instance: every row bit for bit, the maze rows included.
K2_MAZE_LAYOUT = dict(K2_LAYOUT, bitwise=True)
K5_LAYOUT = dict(exact=[7, 8, 12, 17], done=12, seed=16,
                 close=(("states", slice(0, 4), 2e-4, 2e-5), ("inertia", slice(4, 7), 1e-6, 0.0),
                        ("statistics", slice(9, 16), 2e-4, 1e-5)))


# The impulse on the cart of K5's and K6's checks, config 2's action white
# noise, and the circle K6 and K8 track in theirs.
IMPULSE_CP = {"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.4, "duration": 4,
                           "decay_rate": 0.8},)}
ACT_NOISE_CP = {"action": ({"disturbance_func": "white_noise", "std": 0.2},)}
TRACK_CIRCLE = dict(task="traj_tracking",
                    task_info={"trajectory_type": "circle", "trajectory_plane": "xz"})
# The observation white noise of tests/test_fast_policy.py:131-132.
OBS_NOISE = {"observation": ({"disturbance_func": "white_noise", "std": 0.05},)}


def cfg4_gh(noise=True, **kw):
    """Config 4-GH (no BASELINE config): config 4 with the normalized action
    space, two goal-horizon blocks (obs 36, the horizon of
    tests/test_fast_policy.py:217) and, with ``noise``, OBS_NOISE."""
    dist = {**cfg4().disturbances, **(OBS_NOISE if noise else {})}
    return cfg4(**{"normalized_rl_action_space": True, "obs_goal_horizon": 2,
                   "disturbances": dist, **kw})


def cfg_quad2d_gh(**kw):
    """The quad-2D stabilization task with two goal-horizon blocks (the goal
    appended once: obs 12) and OBS_NOISE."""
    return cfg_quad2d_rl(**{"obs_goal_horizon": 2, "disturbances": OBS_NOISE, **kw})


def plan_batches(groups, lanes):
    """For each group size but the widest, the largest batch at which a K5,
    K6, K7 or K8 launch plan (``fast_cartpole.plan_group``) picks it, less
    one, so that the last block is ragged: those instances are checked
    against the plain versions too."""
    return [lanes // g - 1 for g in sorted(groups)[:-1]]


def k7_layout(nx):
    """K7's rows (fast_quad_planar.rows_layout): state | mass | iyy | step |
    offset | stats(7) | seed | ep."""
    st = nx + 4
    return dict(exact=[nx + 2, nx + 3, st + 3, nx + 12], done=st + 3, seed=nx + 11,
                close=(("states", slice(0, nx), 2e-4, 2e-5),
                       ("mass and inertia", slice(nx, nx + 2), 1e-6, 0.0),
                       ("statistics", slice(st, st + 7), 2e-4, 1e-5)))

# Data-sheet peaks of an H100 SXM: HBM3 bytes/s, and float32 and float64
# operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F64_OPS_S = 34e12

# Operation counts by hand from csrc/lane_group.cuh (the derivative and the
# substeps), csrc/quad3d.cuh and csrc/quad3d_rollout.cu.
# Each transcendental (sin, cos, exp, sqrt) counts as one operation, which
# keeps the bound a lower bound (an accurate sinf is ~20-40 instructions).
FC_OPS, FC_TRANS = 71, 6  # one rigid-body derivative
RK4_SUBSTEP_OPS = 4 * FC_OPS + 3 * 12 * 2 + 12 * 7  # 4 evals, 3 axpy, combine
ACTUATE_OPS, ACTUATE_TRANS = 10, 1  # per motor
# K2 per env-step beyond the substeps: impulse 8+1, 1/mass, figure-8 goal
# 48+2, violation and bound tests 36, reward 50+1, done 3, statistics 16.
K2_STEP_OPS, K2_STEP_TRANS = 8 + 1 + 48 + 36 + 50 + 3 + 16, 1 + 2 + 1
K2_RESET_OPS = 300  # per auto-reset: 17 counter hashes and affine draws

# The training path (bench.py rl_train): PPO on config 4 with the
# normalized action space, B x T env-steps per train step, EPOCHS epochs of
# N_MINI minibatches of MB samples.
TRAIN_B, TRAIN_T, EPOCHS, HIDDEN = 4096, 128, 10, 64
MB = TRAIN_B * TRAIN_T // 4
N_MINI = TRAIN_B * TRAIN_T // MB
TRAIN_STEPS = 3
# Profiler sessions of one train step tried before a training path's
# profile fails for want of its policy kernel or K4 (train_profile).
TRAIN_PROFILE_SESSIONS = 4
# K3, K6 and K8 against their plain versions: both sides run the same float32 operations
# in the same order (-fmad=false), but tanh, log, cos and exp are CUDA's
# libdevice functions in the kernel and PyTorch's CUDA operators in the
# plain version, which may round differently in the last place.  The record
# and state rows are therefore held at the JAX suite's state tolerance;
# done, truncation and the integer rows exactly.
K3_RTOL, K3_ATOL = 2e-4, 2e-5
# K4 against its plain version and torch.autograd: sums in other orders
# (the JAX suite's gradient tolerance); loss sums of up to ~1e5 in size
# at rtol 2e-4 with an atol for the one that cancels (sum of logp
# differences).  The actor's hidden-layer gradients are ~1e-5 in size at
# these shapes (a 1/mb factor and an output gain of 0.01), so each
# segment's atol is also held to K4_ATOL_REL times its reference's largest
# entry: float32 sums in other orders stay within ~5e-6 of it (float32
# against float64 on the CPU), and a wrong kernel does not.
K4_RTOL, K4_ATOL, K4_ATOL_REL = 2e-4, 2e-6, 2e-5
K4_SUM_RTOL, K4_SUM_ATOL = 2e-4, 1e-2

# K3 operations per env-step beyond K2's step, the products the function
# needs (csrc/quad3d_policy_rollout.cu skips the zero blocks of the packed
# layout): multiply and add of the actor's and the critic's three layers,
# their biases, and the tanh of their hidden layers; two Philox-4x32-10
# blocks (10 rounds of 2 multiply-highs, 2 multiplies, 3 xors, 2 key adds);
# Box-Muller, log-prob and the normalized action map (4 x (log, sqrt, cos,
# exp) and ~20 operations per action); the four actuations and the action
# cost.
def k3_mlp_ops(h, nx=12, nu=4):
    return 2 * (nx * 2 * h + 2 * h * h + h * (nu + 1)) + 2 * 2 * h + (nu + 1)


K3_MLP_TRANS_PER_H = 4  # tanh of both hidden layers of both nets
K3_RNG_OPS = 2 * 10 * 9
K3_ACTION_OPS = 4 * (ACTUATE_OPS + ACTUATE_TRANS) + 16
# K2's maze instance per env-step of config 5 beyond its two RK4 substeps
# (csrc/maze.cuh, counted by hand): the action noise (two Philox blocks,
# per motor 6 operations and a log, sqrt and cos, and the actuation), the
# uniform force (one block and 3 x 3), per gate the frame and leg tests (31
# and a sqrt) and the current-gate test and select (5), the current gate's
# 7-ray fan alone (5 and 7 x 13: the step keeps no other gate's hit, though
# the kernel, as the JAX kernel, computes every gate's), per obstacle 9 and
# a sqrt, gate progress, at-goal and completion (21 and a sqrt), 1/mass,
# the violation and done tests (36 + 5), the competition reward (8), the
# statistics (16) and the step counter (3); the goal is constant.  A reset
# adds K2's and the poses' 20 counter draws and affines and 4 sincos.
MAZE_NOISE_OPS = K3_RNG_OPS + 4 * (6 + ACTUATE_OPS) + K3_RNG_OPS // 2 + 9
MAZE_NOISE_TRANS = 4 * (3 + ACTUATE_TRANS)
MAZE_GATE_OPS, MAZE_FAN_OPS, MAZE_OBST_OPS = 31 + 5, 5 + 7 * 13, 9
MAZE_STEP_OPS = (MAZE_NOISE_OPS + 4 * MAZE_GATE_OPS + MAZE_FAN_OPS + 4 * MAZE_OBST_OPS + 21 + 1
                 + 36 + 5 + 8 + 16 + 3)
MAZE_STEP_TRANS = MAZE_NOISE_TRANS + 4 + 4 + 1
K2_MAZE_RESET_OPS = K2_RESET_OPS + 20 * 12 + 4
# K4 operations per sample, counted from csrc/ppo_update.cu as written:
# forward of both nets (multiply-add of three layers, biases, tanh), the
# backward into both hidden layers (tanh' = 1 - a^2), and one multiply-add
# per sample into every weight gradient entry (an add for each bias entry),
# plus the losses (exp of the ratio, 4 exp of logstd, ~60 operations).
def k4_ops_per_sample(nx, nu, h):
    fwd = 2 * (2 * (nx * h + h * h) + (nu + 1) * h) + 2 * h * 2 + (nu + 1) + 2 * 2 * h
    bwd = 2 * (nu + 1) * h + 2 * (2 * h * h) + 2 * 2 * h * 3
    acc = 2 * (2 * (nx * h + h * h) + (nu + 1) * h) + (4 * h + nu + 1 + nu + 3)
    return fwd + bwd + acc + 2 + 4 + 60


# K5 per env-step (csrc/cartpole.cuh, one RK4 substep at 50 Hz): the cart-pole
# derivative is 18 operations and a sine and a cosine; the substep 4 of them,
# 3 axpy of 4 rows and the combine; then impulse, goal (closed-form circle:
# 8 and a sine and cosine), box tests, reward (and its exp), done, freeze,
# statistics.  The action white noise adds one Philox block and Box-Muller.
CP_FC_OPS, CP_FC_TRANS = 18, 2
CP_SUBSTEP_OPS = 4 * CP_FC_OPS + 3 * 4 * 2 + 4 * 7
K5_STEP_OPS, K5_STEP_TRANS = 3 + 1 + 9 + 8 + 10 + 15 + 4 + 8 + 2 + 16, 1 + 2 + 1
K5_NOISE_OPS, K5_NOISE_TRANS = K3_RNG_OPS // 2 + 6, 3
K5_RESET_OPS = 150  # 8 counter hashes and affine draws
# K7 per env-step of the 2D quad (csrc/quad_planar.cuh): the derivative is 9
# operations and a sine and a cosine; an RK4 substep 4 of them, 3 axpy of 6
# rows and the combine; the two actuations, thrust sums and theta_dd, the
# impulse, box tests, reward, done, freeze and statistics.
Q2_FC_OPS, Q2_FC_TRANS = 9, 2
Q2_SUBSTEP_OPS = 4 * Q2_FC_OPS + 3 * 6 * 2 + 6 * 7
K7_STEP_OPS, K7_STEP_TRANS = 2 * 10 + 10 + 1 + 9 + 12 + 25 + 6 + 12 + 18, 2 + 1 + 1
K7_RESET_OPS = 200  # 11 counter hashes and affine draws
# Per action of a policy kernel: Box-Muller, log-prob and the action map
# (~20 operations), and a log, sqrt, cos and exp.
K68_SAMPLE_OPS, K68_SAMPLE_TRANS = 20, 4
# The observation instances (csrc/obs_ext.cuh), per noised state row: its 2
# uniforms (half a Philox block) and Box-Muller (6 operations and a log,
# sqrt and cos); per goal block of the 3D figure-8: K2's goal (48 and a sin
# and a cos; the static goal of stabilization is copied).
OBS_NOISE_ROW_OPS = K3_RNG_OPS // 4 + 6 + 3
GOAL3_OPS = 48 + 2


def counters():
    """Every kernel wrapper's launch counter, by kernel tag."""
    from safe_control_gym_torch.ops import quad_substeps as K1
    from safe_control_gym_torch.parallel import fast_cartpole as FC
    from safe_control_gym_torch.parallel import fast_env as F
    from safe_control_gym_torch.parallel import fast_policy as P
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ
    from safe_control_gym_torch.parallel import fast_update as U

    return {"k1": K1.quad3d_substeps, "k2": F.quad3d_rollout, "k3": P.policy_rollout,
            "k4": U.ppo_grads, "k5": FC.cartpole_rollout, "k6": FC.cartpole_policy_rollout,
            "k7": PQ.planar_rollout, "k8": PQ.planar_policy_rollout}


# The policy kernels' observation instances: their launches (``obs_launches``)
# are also counted in the kernel's own.
OBS_INSTANCES = ("k3", "k6", "k8")


def zero_counters():
    for k, fn in counters().items():
        fn.launches = 0
        if k in OBS_INSTANCES:
            fn.obs_launches = 0
    counters()["k3"].maze_launches = 0


def read_counters():
    """Every kernel's launches, with those of the observation instances
    (``k3_obs``, ...) and K3's maze instances (``k3_maze``) among them."""
    c = counters()
    return {**{k: fn.launches for k, fn in c.items()},
            **{f"{k}_obs": c[k].obs_launches for k in OBS_INSTANCES},
            "k3_maze": c["k3"].maze_launches}


def cuda_ms(fn, reps):
    """Mean time of ``fn`` over ``reps`` back-to-back calls between two CUDA
    events, host launch overhead included."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Mean device time per call of a kernel whose launch takes
    milliseconds (K2-K8): one untimed call first keeps the device busy while
    the host enqueues the timed ones, so the events bracket device work
    alone."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_kernels(fn, reps):
    """Run ``fn`` ``reps`` times under torch.profiler; return (wall ms,
    {kernel name: (device ms total, launches)}) for the CUDA kernels seen.
    The session opens as ``utils/profiling.lead_session`` does (an empty
    session, then the lead spin kernels, left out here): the profiler was
    seen to drop the first events of a session in a process that had
    launched much before, the policy kernel and the first small kernels of
    a train step among them (fault (f), PERF.md)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from safe_control_gym_torch.utils.profiling import LEAD_KERNEL, lead_session

    fn()
    torch.cuda.synchronize()
    with lead_session([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0
            and LEAD_KERNEL not in e.key}
    return wall, kern


def profile_launches(fn):
    """One call of ``fn`` under torch.profiler with the device activity
    alone: (device operations launched (kernels, memsets and copies), their
    device ms in all, the five names launched most).  The session opens with
    the lead spin kernels (``utils/profiling.lead_session``, no empty session
    first).  Reads the profiler's raw events: ``key_averages`` builds a
    Python event per record, which over a solve's ~7e4 launches takes longer
    than the solve, and the CPU activity multiplies the records."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from safe_control_gym_torch.utils.profiling import LEAD_KERNEL, lead_session

    torch.cuda.synchronize()
    with lead_session([ProfilerActivity.CUDA], empty_first=False) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and LEAD_KERNEL not in e.name()]
    names = collections.Counter(e.name()[:80] for e in evs)
    return len(evs), sum(e.duration_ns() for e in evs) / 1e6, names.most_common(5)


def kernel_device_ms(fn, name, reps, sessions=3):
    """Mean device time per launch of the kernel whose name holds ``name``.
    A session in which the profiler recorded no kernel at all (seen for
    about one K1 session in fifteen on the H100) is run again, up to
    ``sessions`` in all; raises where none recorded it."""
    for _ in range(sessions):
        _, kern = profile_kernels(fn, reps)
        hits = [(t, n) for k, (t, n) in kern.items() if name in k]
        if hits:
            return sum(t for t, _ in hits) / sum(n for _, n in hits)
        print(f"  profiler: no device time for {name} in a session (kernels seen: "
              f"{sorted(kern)}); profiling again", flush=True)
    raise RuntimeError(f"the profiler recorded no device time for {name} in {sessions} "
                       "sessions")


def train_profile(step, kname, sessions=TRAIN_PROFILE_SESSIONS):
    """{kernel: (device ms, launches)} of one profiled train step, from the
    first session in which the profiler recorded both the policy kernel
    ``kname`` and K4 (``ppo_grads``): it was seen to drop all of a kernel's
    events in a session (PERF.md).  Up to ``sessions`` sessions; raises
    where none recorded both."""
    for _ in range(sessions):
        _, kern = profile_kernels(step, 1)
        seen = {name: any(name in k for k in kern) for name in (kname, "ppo_grads")}
        if all(seen.values()):
            return kern
        print(f"  profiler: a train-step session without {sorted(n for n, s in seen.items() if not s)}"
              f"; kernels seen ({len(kern)}): {sorted(k[:60] for k in kern)}; profiling again",
              flush=True)
    raise RuntimeError(f"the profiler recorded {kname} and ppo_grads together in none of "
                       f"{sessions} train-step sessions")


def check(name, ok, detail):
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        raise AssertionError(f"{name} failed: {detail}")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def check_rows(tag, out, ref, rows_in, layout):
    """All state rows a whole-rollout kernel left against its plain
    version's on the same input rows (``layout``: K2_LAYOUT, K5_LAYOUT,
    k7_layout(nx)); returns the largest absolute difference on the float
    rows."""
    import torch

    ex, d = layout["exact"], layout["done"]
    diff = (out[ex] != ref[ex]).any(0)
    done_k, done_p = int(out[d].sum()), int(ref[d].sum())
    check(f"{tag}: step, offset, done and episode rows", not bool(diff.any()) and done_k > 0,
          f"episodes {done_k} vs {done_p}; {int(diff.sum())} envs differ (exact)")
    seed = rows_in[layout["seed"]].view(torch.int32)
    check(f"{tag}: seed row bits", torch.equal(out[layout["seed"]].view(torch.int32), seed)
          and torch.equal(ref[layout["seed"]].view(torch.int32), seed), "copied through unchanged")
    if layout.get("bitwise"):
        differ = (out.view(torch.int32) != ref.view(torch.int32)).any(1).nonzero().flatten()
        check(f"{tag}: every row bit for bit", differ.numel() == 0,
              f"{out.shape[0]} rows; rows that differ: {differ.tolist()}")
    errs = []
    for what, rs, rtol, atol in layout["close"]:
        err = max_err(out[rs], ref[rs])
        errs.append(err)
        check(f"{tag}: {what}", bool(torch.isclose(out[rs], ref[rs], rtol=rtol, atol=atol).all()),
              f"max_abs_err {err:.3g} (rtol {rtol:g}, atol {atol:g})")
    return max(errs)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def phase_build():
    import torch

    from safe_control_gym_torch import kernels

    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    build_s = time.perf_counter() - t0
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"[ok] build: {build_s:.1f} s")
    regs = ptxas_summary((kernels.BUILD / "ptxas.log").read_text())
    for name, r in regs.items():
        print(f"  ptxas: {name}: {r['registers']} registers, {r['spill_stores']} / "
              f"{r['spill_loads']} bytes spill stores / loads")
    spills = {k: r for k, r in regs.items() if r["spill_stores"] or r["spill_loads"]}
    print(f"  ptxas: {len(regs)} kernels, spills in {sorted(spills) or 'none'}")
    return build_s, regs


def ptxas_summary(log):
    """{entry function: registers and spill bytes} from ``nvcc -Xptxas -v``
    output (mangled names, the template arguments in them)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def k1_switch_batches(dtype):
    """The batches at which K1's launch plan changes group for ``dtype``:
    for each group of ``quad_substeps.PLAN_MAX_B``, the last batch that
    takes it and the first that takes the next narrower one."""
    from safe_control_gym_torch.ops import quad_substeps as K1

    return sorted({b for most in K1.PLAN_MAX_B[dtype].values() for b in (most, most + 1)})


def k1_inputs(dev, B, dtype, seed=0):
    """K1's random inputs: states, thrust commands through both PWM clip
    limits, small external forces, config 4's mass and inertia."""
    import torch

    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((B, 12)) * 0.2, dtype=dtype, device=dev)
    thr = torch.tensor(rng.uniform(0.0, 0.16, (B, 4)), dtype=dtype, device=dev)
    ext = torch.tensor(rng.standard_normal((B, 3)) * 1e-3, dtype=dtype, device=dev)
    m = torch.full((B,), 0.027, dtype=dtype, device=dev)
    j = torch.tensor([1.4e-5, 1.4e-5, 2.17e-5], dtype=dtype, device=dev).repeat(B, 1)
    return x, thr, ext, m, j


def phase_k1(dev):
    """K1 against its plain version bit for bit, float32 and float64, RK4
    and Euler, actuation on and off: at every group the source builds at
    the ragged B = RAGGED_B and at B = B_MAIN, and with the launch plan's
    own group at the batches where the plan changes group.  Returns the
    largest error by scalar type (0 when bit-equal) and B_MAIN's float32
    inputs."""
    import itertools

    import torch

    from safe_control_gym_torch.ops import quad_substeps as K1

    errs = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        cases = [(B, g) for B in (RAGGED_B, B_MAIN) for g in K1.GROUPS]
        cases += [(B, None) for B in k1_switch_batches(dtype)]
        for B, group in cases:
            args = k1_inputs(dev, B, dtype)
            err, same = 0.0, True
            for euler, actuation in itertools.product((False, True), (False, True)):
                kw = dict(dt=1 / 240, n_sub=4, euler=euler, actuation=actuation)
                out = K1.quad3d_substeps(*args, group=group, **kw)
                ref = K1.quad3d_substeps_plain(*args, **kw)
                torch.cuda.synchronize()
                err = max(err, max_err(out, ref))
                same = same and out.dtype == dtype and bool(torch.isfinite(out).all()) \
                    and torch.equal(out, ref)
            errs[name] = max(errs.get(name, 0.0), err)
            g = K1.launch_plan(B, dtype, group)[0]
            check(f"K1 {name} G={g}{'' if group else ' (plan)'} vs plain (B={B}; RK4, Euler; "
                  "actuation on, off)", same, f"max_abs_err {err:.3g} (bit-equal expected)")
    return errs, k1_inputs(dev, B_MAIN, torch.float32)


def phase_k1_float64(dev, k1_inputs):
    """K1's float64 instance, the fidelity path: against its plain version
    on the card in float64 on phase_k1's random states at B = 4096, RK4 and
    Euler, within 1e-12 of max(1, |ref|), timed by the profiler; then a
    float64 3D env (config 4's dynamics, no disturbance, 64 envs, 30 steps
    near hover) steps on the card through it, one K1 launch a step, and
    agrees with the same env on the CPU (the plain version); a float32 env
    launches K1 once a step."""
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.ops import quad_substeps as K1

    args = tuple(a.double() for a in k1_inputs)
    kw = dict(dt=1 / 240, n_sub=4, actuation=True)
    out = {"max_abs_err": 0.0}
    fn = lambda: K1.quad3d_substeps(*args, euler=False, **kw)  # noqa: E731
    out["ms"] = kernel_device_ms(fn, "quad3d_substeps_kernel", 200)
    out["plain_ms"] = cuda_ms(lambda: K1.quad3d_substeps_plain(*args, euler=False, **kw), 20)
    for euler in (False, True):
        got = K1.quad3d_substeps(*args, euler=euler, **kw)
        ref = K1.quad3d_substeps_plain(*args, euler=euler, **kw)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        rel = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        check(f"K1 float64 {'euler' if euler else 'rk4'} vs plain (B={args[0].shape[0]})",
              got.dtype == torch.float64 and bool(torch.isfinite(got).all()) and rel <= 1e-12,
              f"max_abs_err {err:.3g}, max err/max(1,|ref|) {rel:.3g} (tolerance 1e-12)")

    B, T = 64, 30
    seeds = torch.arange(B, dtype=torch.int32)
    cfg = cfg4(disturbances=None, dtype=torch.float64)
    thrust = 0.027 * 9.8 / 4 * (1.0 + 0.05 * np.random.default_rng(7).standard_normal((T, B, 4)))
    xs = {}
    for where in ("cpu", dev):
        env = make_quadrotor(cfg, device=where)
        state, _, _ = env.reset(seeds)
        before = K1.quad3d_substeps.launches
        for t in range(T):
            state, _, _, _, _ = env.step(state, torch.tensor(thrust[t], dtype=torch.float64))
        xs[str(where)] = (state.x.cpu(), K1.quad3d_substeps.launches - before)
    err = max_err(xs["cpu"][0], xs[str(dev)][0])
    out["env_launches"], out["env_vs_cpu_max_abs_err"] = xs[str(dev)][1], err
    check("float64 3D env on the card: K1's float64 instance",
          xs[str(dev)][1] == T and xs["cpu"][0].dtype == torch.float64 and err <= 1e-10,
          f"K1 launches {xs[str(dev)][1]} in {T} steps, max_abs_err {err:.3g} from the CPU env "
          "(tolerance 1e-10)")
    env = make_quadrotor(cfg4(), device=dev)
    state, _, _ = env.reset(seeds)
    before = K1.quad3d_substeps.launches
    env.step(state, torch.full((B, 4), float(env.u_goal[0]), device=dev))
    check("float32 3D env on the card: K1", K1.quad3d_substeps.launches == before + 1,
          f"K1 launches {K1.quad3d_substeps.launches - before}")
    return out


# The native runtime's path (``phase_native``): tests/test_native.py's 3D
# quad and tolerance, at config 4's batch, each env under its own seeded
# thrusts; a ring of NATIVE_RING records of (t, 12 states).
NATIVE_B, NATIVE_STEPS, NATIVE_SEED = B_MAIN, 40, 11
NATIVE_RTOL, NATIVE_ATOL = 1e-9, 1e-10
NATIVE_RING = 32
NATIVE_QUAD3D = dict(quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=2,
                     task="stabilization", cost="quadratic", randomized_init=False,
                     init_state={"init_z": 1.0}, randomized_inertial_prop=False,
                     done_on_out_of_bound=False)


def native_cases():
    """tests/test_native.py:64-77's inputs of the compiled oracle against its
    NumPy fallback: (CartPole args, 3D quad args)."""
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=4) * 0.1
    forces = rng.uniform(-5, 5, size=(20, 1))
    mass, j = 0.03454, np.array([1.4e-5, 1.4e-5, 2.17e-5])
    q0 = np.zeros(12)
    q0[4] = 1.0
    thrusts = mass * 9.8 / 4 * (1 + 0.05 * rng.standard_normal((25, 4)))
    return (x0, forces, 0.02, 2, 1.0, 0.1, 1.0), (q0, thrusts, 1 / 240, 3, mass, j)


def phase_native(dev):
    """The port's native runtime (``safe_control_gym_torch/native``: the host
    C++ oracle and flight logger).  (a) Built from the checkout's source with
    g++ and loaded from the port's build directory, never its NumPy
    fallback.  (b) tests/test_native.py's 3D quad (60/240 Hz, stabilization,
    no randomization, z = 1) on the card in float64 at B = NATIVE_B, each env
    under its own thrusts hover x (1 + 0.03 N(0, 1)) for NATIVE_STEPS control
    steps after one warm-up run, the launch counters zeroed just before and
    read just after (K1's float64 instance once a step, nothing else); every
    env's trajectory against the oracle on the host at rtol 1e-9 / atol
    1e-10.  (c) The compiled oracle against its NumPy fallback (CartPole
    rtol 1e-12, the 3D quad 1e-10, atol 1e-12).  (d) Env 0's states as (t, x)
    records into a ring of NATIVE_RING: the snapshot is the last NATIVE_RING
    records bit for bit, and its CSV reads back equal."""
    import tempfile
    from pathlib import Path

    import torch

    from safe_control_gym_torch import native
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.native import _fallback

    t0 = time.perf_counter()
    lib_path = native.build(force=True)
    lib = native.load()
    res = {"build_s": time.perf_counter() - t0, "library": str(lib_path)}
    home = Path(ROOT) / "safe_control_gym_torch" / "native" / "build"
    check("native: the port's library, built with g++ and loaded", native.available()
          and lib._name == str(lib_path) == str(native.LIB) and lib_path.parent == home,
          f"{lib_path} in {res['build_s']:.2f} s (no NumPy fallback)")

    # (b) the float64 3D env on the card against the oracle on the host.
    cfg = QuadrotorConfig(**NATIVE_QUAD3D, dtype=torch.float64)
    n_sub, dt = cfg.pyb_freq // cfg.ctrl_freq, 1.0 / cfg.pyb_freq
    B, T = NATIVE_B, NATIVE_STEPS
    env = make_quadrotor(cfg, device=dev)
    hover = float(env.u_goal[0])
    thrusts = hover * (1 + 0.03 * np.random.default_rng(NATIVE_SEED).standard_normal((B, T, 4)))
    thr = torch.tensor(thrusts.transpose(1, 0, 2), dtype=torch.float64, device=dev)

    def fly():
        state, _, _ = env.reset(torch.arange(B, dtype=torch.int32))
        xs = [state.x]
        for t in range(T):
            state, _, _, _, _ = env.step(state, thr[t])
            xs.append(state.x)
        return state, torch.stack(xs)

    fly()
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    state, xs = fly()
    torch.cuda.synchronize()
    res["card_ms_per_step"] = (time.perf_counter() - t0) / T * 1e3
    res["launches"] = read_counters()
    check("native: the float64 3D env on the card runs K1's float64 instance once a step",
          res["launches"]["k1"] == T and sum(res["launches"].values()) == T
          and xs.dtype == torch.float64, f"launches {res['launches']} in {T} steps at B={B}")
    got = xs.cpu().numpy()
    x0 = np.zeros(12)
    x0[4] = 1.0
    mass, j = state.mass.cpu().numpy(), state.j_diag.cpu().numpy()
    t0 = time.perf_counter()
    want = np.stack([native.quad3d_rollout(got[0, b], thrusts[b], dt, n_sub, mass[b], j[b])
                     for b in range(B)], 1)
    res["oracle_ms"] = (time.perf_counter() - t0) * 1e3
    diff = np.abs(got - want)
    res["max_abs_err"] = float(diff.max())
    res["max_rel_err"] = float((diff / np.maximum(np.abs(want), 1.0)).max())
    check(f"native: {B} float64 trajectories on the card against the C++ oracle",
          bool((got[0] == x0).all()) and np.isfinite(got).all()
          and np.allclose(got, want, rtol=NATIVE_RTOL, atol=NATIVE_ATOL),
          f"{T} steps; max_abs_err {res['max_abs_err']:.3g}, max err/max(1,|ref|) "
          f"{res['max_rel_err']:.3g} (rtol {NATIVE_RTOL:g}, atol {NATIVE_ATOL:g})")

    # (c) the compiled oracle against its NumPy fallback.
    cp, q = native_cases()
    res["fallback_err"] = {}
    for tag, fn, args, rtol in (("CartPole", "cartpole_rollout", cp, 1e-12),
                                ("3D quad", "quad3d_rollout", q, 1e-10)):
        a, b = getattr(native, fn)(*args), getattr(_fallback, fn)(*args)
        res["fallback_err"][tag] = float(np.abs(a - b).max())
        check(f"native: {tag} oracle against its NumPy fallback",
              np.allclose(a, b, rtol=rtol, atol=1e-12),
              f"{a.shape}, max_abs_err {res['fallback_err'][tag]:.3g} (rtol {rtol:g}, atol 1e-12)")

    # (d) the flight logger on env 0's flight.
    records = np.concatenate([np.arange(1, T + 1)[:, None] / cfg.ctrl_freq, got[1:, 0]], 1)
    lg = native.NativeFlightLogger(NATIVE_RING, 13, header="t," + ",".join(
        f"x{i}" for i in range(12)))
    lg.append(records)
    snap = lg.snapshot()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flight.csv")
        lg.flush_csv(path)
        back = np.loadtxt(path, delimiter=",", skiprows=1)
    check("native: the flight logger keeps the last records bit for bit",
          isinstance(lg, native.NativeFlightLogger) and lg.count == T
          and snap.tobytes() == records[-NATIVE_RING:].tobytes()
          and back.tobytes() == snap.tobytes(),
          f"{lg.count} records of 13 into a ring of {NATIVE_RING}: snapshot {snap.shape}, the CSV "
          "read back equal")
    print(f"  native: build {res['build_s']:.2f} s ({lib_path}); float64 3D env on the card "
          f"{res['card_ms_per_step']:.3f} host ms a step at B={B} ({T} steps, K1 "
          f"{res['launches']['k1']}); the oracle on the host {res['oracle_ms']:.1f} ms for {B} "
          f"envs x {T} steps; max_abs_err {res['max_abs_err']:.3g}; {card_line()}", flush=True)
    return res


def phase_k2(dev):
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_env as F

    env = make_quadrotor(cfg4(episode_len_sec=0.2), device=dev)
    err = 0.0
    for B in (RAGGED_B, CHECK_B):
        fr = F.FastQuadRollout(env, B, steps_per_call=CHECK_STEPS, device=dev)
        rows0 = fr.reset(seed=0)
        act = fr.prepare_action(np.full(4, float(env.u_goal[0])))
        out = fr.run(rows0, act)
        ref = F.quad3d_rollout_plain(fr.params, rows0, act)
        torch.cuda.synchronize()
        err = max(err, check_rows(f"K2 vs plain (B={B}, {CHECK_STEPS} steps)", out, ref, rows0,
                                  K2_LAYOUT))
    return err, env, fr, rows0, out


def phase_cross(dev, env, fr, rows0, rows_k2):
    import torch

    from safe_control_gym_torch.parallel import rollout as R
    from safe_control_gym_torch.parallel.vector import make_vec_env

    vec = make_vec_env(env, CHECK_B)
    state, obs, _ = vec.reset(seed=0)
    check("reset rows vs general-engine reset",
          torch.equal(fr.pack(state).view(torch.int32), rows0.view(torch.int32)),
          "bit-identical packed state")
    hover = torch.full((CHECK_B, 4), float(env.u_goal[0]), device=dev)
    carry = R.RolloutCarry(state, obs, (), R.EpisodeStats.create(CHECK_B, device=dev))
    carry, _ = R.rollout(vec, lambda ps, o: (hover, ps), carry, CHECK_STEPS, collect=False)
    es = carry.env_state
    torch.cuda.synchronize()
    done_same = torch.equal(rows_k2[21], carry.stats.done_count.float())
    check("K2 vs general engine: done counts", done_same,
          f"{int(rows_k2[21].sum())} vs {int(carry.stats.done_count.sum())} episodes")
    same = (torch.equal(rows_k2[26], es.episode_idx.float())
            and torch.equal(rows_k2[16], es.ctrl_step.float())
            and torch.equal(rows_k2[17], es.dist_offsets["dynamics"][:, 0].float()))
    check("K2 vs general engine: episode, step and offset rows", same, "exact")
    err = max_err(rows_k2[:12].T, es.x)
    close = bool(torch.isclose(rows_k2[:12].T, es.x, rtol=2e-4, atol=2e-5).all())
    check("K2 vs general engine: states", close, f"max_abs_err {err:.3g} (rtol 2e-4, atol 2e-5)")
    return err


def phase_k2_maze(dev):
    """K2's maze instance against its plain version, every row bit for bit,
    at the ragged B = 1000 and at B = 4096: config 5 with 4 s episodes and
    its step noise, MAZE_CHECK_STEPS hover steps through collision resets
    (and the pose redraws that follow them)."""
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_env as F

    env = make_quadrotor(cfg5(episode_len_sec=4), device=dev)
    err = 0.0
    for B in (RAGGED_B, B_MAIN):
        fr = F.FastQuadRollout(env, B, steps_per_call=MAZE_CHECK_STEPS, device=dev)
        rows0 = fr.reset(seed=0)
        act = fr.prepare_action(np.full(4, float(env.u_goal[0])))
        seed = torch.tensor([5], dtype=torch.int32, device=dev)
        out = F.quad3d_rollout(fr.params, rows0, act, seed)
        ref = F.quad3d_rollout_plain(fr.params, rows0, act, seed)
        torch.cuda.synchronize()
        tag = f"K2 maze instance vs plain (config 5, B={B}, {MAZE_CHECK_STEPS} steps)"
        err = max(err, check_rows(tag, out, ref, rows0, K2_MAZE_LAYOUT))
        g = slice(27, 27 + 4 * fr.params["n_gates"])
        moved = int((out[g] != rows0[g]).any(0).sum())
        check(f"{tag}: pose redraws", moved > B // 2, f"{moved} of {B} envs' gates redrawn")
    return err


def phase_maze_cross(dev):
    """One K2 step of config 5 against the general engine (K1) from
    MAZE_CROSS_B scattered spawns at step 40 (tests/test_fast_maze.py's
    check): envs 0-63 placed in their current gate's aperture, envs 64-95
    at the goal past the last gate one step from completion; no step noise.
    K2 against its plain version on the same rows, bit for bit."""
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_env as F
    from safe_control_gym_torch.parallel.vector import make_vec_env

    B = MAZE_CROSS_B
    env = make_quadrotor(cfg5(episode_len_sec=4, disturbances=None, randomized_inertial_prop=False,
                              init_state_randomization_info=MAZE_SCATTER, done_on_completion=True),
                         device=dev)
    state, _, _ = make_vec_env(env, B).reset(seed=3)
    x, cur, at_goal = state.x.clone(), state.current_gate.clone(), state.steps_at_goal.clone()
    x[:96] = 0.0
    x[:64, 0], x[:64, 2], x[:64, 4] = (state.gates_eff[:64, 0, k] for k in (0, 1, 3))
    x[64:96, 0], x[64:96, 2], x[64:96, 4] = (float(env.x_goal[k]) for k in (0, 2, 4))
    cur[64:96], at_goal[64:96] = len(env.config.gates), 2 * env.config.ctrl_freq
    full = torch.full_like(cur, 40)
    state = state.replace(x=x, ctrl_step=full, pyb_step=2 * full, current_gate=cur,
                          steps_at_goal=at_goal)
    fr = F.FastQuadRollout(env, B, steps_per_call=1, device=dev)
    hover = np.full(4, float(env.u_goal[0]), np.float32)
    rows_in, act = fr.pack(state), fr.prepare_action(hover)
    seed = torch.tensor([1], dtype=torch.int32, device=dev)
    rows = F.quad3d_rollout(fr.params, rows_in, act, seed)
    s1, _, rew, done, _ = env.step(state, torch.as_tensor(np.tile(hover, (B, 1)), device=dev))
    torch.cuda.synchronize()
    check_rows(f"K2 maze instance vs plain (placed and scattered, B={B}, 1 step)", rows,
               F.quad3d_rollout_plain(fr.params, rows_in, act, seed), rows_in, K2_MAZE_LAYOUT)
    done_k = rows[21] > 0.5
    check("K2 maze vs general engine: done", torch.equal(done_k, done),
          f"{int(done_k.sum())} vs {int(done.sum())} of {B} done")
    rew_err = max_err(rows[18] + rows[22], rew)
    check("K2 maze vs general engine: reward", rew_err <= 1e-4, f"max_abs_err {rew_err:.3g} (1e-4)")
    live = ~done
    err = max_err(rows[:12, live].T, s1.x[live])
    close = bool(torch.isclose(rows[:12, live].T, s1.x[live], rtol=2e-4, atol=2e-5).all())
    check("K2 maze vs general engine: states of the envs not done", close,
          f"max_abs_err {err:.3g} (rtol 2e-4, atol 2e-5)")
    mz = 27 + 4 * fr.params["n_gates"] + 2 * fr.params["n_obstacles"]
    same = (torch.equal(rows[mz, live], s1.current_gate[live].float())
            and torch.equal(rows[mz + 1, live], s1.steps_at_goal[live].float()))
    passed = int(s1.stepped_through_gate[:64].sum())
    check("K2 maze vs general engine: gate and goal counters", same and passed == 64
          and bool(s1.task_completed[64:96].all()) and bool(done_k[64:96].all()),
          f"exact; {passed} of 64 placed envs passed their gate, 32 completed")
    share = float(done.double().mean())
    check("K2 maze vs general engine: done share", 0.005 < share < 0.9, f"{share:.4f}")
    return err


def phase_serve_maze(dev):
    """Config 5 served at B = 4096: the general engine (K1 once a step), then
    K2's maze instance, 8192 steps a call."""
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_env as F

    env = make_quadrotor(cfg5(), device=dev)
    fr = F.FastQuadRollout(env, B_MAIN, FAST_STEPS, device=dev)
    res = serve(dev, "config 5", env, fr, fr.prepare_action(np.full(4, float(env.u_goal[0]))),
                F.quad3d_rollout, F.quad3d_rollout_plain, "quad3d_rollout", "k2", K2_MAZE_LAYOUT,
                21, plain_steps=MAZE_PLAIN_STEPS)
    gl = res["general_launches"]
    check("config 5 general engine went through K1", gl["k1"] == SERVE_GENERAL_STEPS
          and sum(gl.values()) == gl["k1"], f"launches {gl} in {SERVE_GENERAL_STEPS} steps")
    return res


def phase_main(dev):
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.ops import quad_substeps as K1
    from safe_control_gym_torch.parallel import fast_env as F
    from safe_control_gym_torch.parallel import rollout as R
    from safe_control_gym_torch.parallel.vector import make_vec_env

    env = make_quadrotor(cfg4(), device=dev)
    hover_f = float(env.u_goal[0])
    res = {}

    # -- general engine: make_vec_env + rollout, K1 once per step.
    vec = make_vec_env(env, B_MAIN)
    hover = torch.full((B_MAIN, 4), hover_f, device=dev)
    policy = lambda ps, o: (hover, ps)  # noqa: E731

    state, obs, _ = vec.reset(seed=0)
    carry0 = R.RolloutCarry(state, obs, (), R.EpisodeStats.create(B_MAIN, device=dev))

    def general():
        return R.rollout(vec, policy, carry0, GENERAL_STEPS, collect=False)[0]

    general()
    general()
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    carry = general()
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    res["general_launches"] = read_counters()
    res["k1_launches"] = res["general_launches"]["k1"]
    check("general engine output", bool(torch.isfinite(carry.env_state.x).all())
          and tuple(carry.env_state.x.shape) == (B_MAIN, 12),
          f"finite (B, 12) states; {carry.stats.means()}")
    res["general_env_steps_s"] = B_MAIN * GENERAL_STEPS / t_gen
    res["general_s"] = t_gen

    # -- whole-rollout engine: one launch of FAST_STEPS steps.
    fr = F.FastQuadRollout(env, B_MAIN, steps_per_call=FAST_STEPS, device=dev)
    act = fr.prepare_action(np.full(4, hover_f))
    rows_in = fr.run(fr.reset(seed=0), act)
    rows_in = fr.run(rows_in, act)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    rows = fr.run(rows_in, act)
    torch.cuda.synchronize()
    t_fast = time.perf_counter() - t0
    res["fast_launches"] = read_counters()
    res["k2_launches"] = res["fast_launches"]["k2"]
    res["fast_env_steps_s"] = B_MAIN * FAST_STEPS / t_fast
    res["fast_call_ms"] = t_fast * 1e3
    res["fast_resets"] = float(rows[21].sum() - rows_in[21].sum())
    body = torch.cat([rows[:25], rows[26:]])
    check("whole-rollout output", bool(torch.isfinite(body).all()),
          f"finite rows; {fr.stats(rows)}")
    others = sum(v for k, v in res["general_launches"].items() if k != "k1") \
        + sum(v for k, v in res["fast_launches"].items() if k != "k2")
    check("main path went through the kernels",
          res["k1_launches"] == GENERAL_STEPS and res["k2_launches"] == 1 and others == 0,
          f"K1 launches {res['k1_launches']} in {GENERAL_STEPS} general steps, "
          f"K2 launches {res['k2_launches']} in one whole-rollout call, {others} others")

    # -- where the general engine's time goes: device busy share and the
    # kernels that take it, over 32 steps.
    short = lambda: R.rollout(vec, policy, carry0, 32, collect=False)  # noqa: E731
    _, kern = profile_kernels(short, 1)
    busy = sum(t for t, _ in kern.values())
    t0 = time.perf_counter()
    short()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3  # without the profiler's overhead
    k1_dev = sum(t for k, (t, _) in kern.items() if "quad3d_substeps_kernel" in k)
    res["general_profile"] = {
        "wall_ms": wall, "device_ms": busy, "busy_share": busy / wall if wall else None,
        "k1_device_ms": k1_dev, "k1_device_share": k1_dev / busy if busy else None,
        "kernel_launches": sum(n for _, n in kern.values()),
        "top": sorted(((k[:80], t, n) for k, (t, n) in kern.items()),
                      key=lambda r: -r[1])[:6]}

    # -- K1 at the general engine's inputs (reset states, hover, no
    # impulse): against its plain version, then timed alone.  ``ms`` is the
    # profiler's device time; the CUDA-event time of back-to-back launches
    # from Python (host launch overhead included) is kept beside it.
    state, _, _ = vec.reset(seed=0)
    ext = torch.zeros((B_MAIN, 3), device=dev)
    k1_args = (state.x, hover, ext, state.mass, state.j_diag)
    k1_kw = dict(dt=1 / 240, n_sub=4, euler=False, actuation=True)
    fn = lambda: K1.quad3d_substeps(*k1_args, **k1_kw)  # noqa: E731
    out, ref = fn(), K1.quad3d_substeps_plain(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    res["k1_main_max_abs_err"] = max_err(out, ref)
    rel = float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max())
    check(f"K1 vs plain on the general engine's inputs (B={B_MAIN})", rel <= 2e-6,
          f"max_abs_err {res['k1_main_max_abs_err']:.3g}, max err/max(1,|ref|) {rel:.3g} "
          "(tolerance 2e-6)")
    cuda_ms(fn, 50)
    res["k1_launch_ms"] = cuda_ms(fn, 2000)
    res["k1_ms"] = kernel_device_ms(fn, "quad3d_substeps_kernel", 200)
    res["k1_plain_ms"] = cuda_ms(lambda: K1.quad3d_substeps_plain(*k1_args, **k1_kw), 20)
    res["k2_ms"] = device_ms(lambda: F.quad3d_rollout(fr.params, rows_in, act), 3)

    # -- K2 and its plain version on a PLAIN_STEPS-step call from the
    # timed call's own rows and action: K2's check at the main path's width,
    # and the plain version's time (PERF.md keeps the 8192-step agreement).
    p_short = dict(fr.params, steps=PLAIN_STEPS)
    rows_k = F.quad3d_rollout(p_short, rows_in, act)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rows_plain = F.quad3d_rollout_plain(p_short, rows_in, act)
    end.record()
    torch.cuda.synchronize()
    res["k2_plain_ms"] = start.elapsed_time(end)
    res["k2_main_max_abs_err"] = check_rows(
        f"K2 vs plain from the main path's rows (B={B_MAIN}, {PLAIN_STEPS} steps)", rows_k,
        rows_plain, rows_in, K2_LAYOUT)
    return res


def seeded_ac(dev, seed=0, nx=12, nu=4, hidden=HIDDEN):
    """Actor-critic of the rl_train widths (or ``hidden``) with weights from
    a fixed seed."""
    import torch

    from safe_control_gym_torch.controllers.ppo import ActorCritic

    ac = ActorCritic(nx, nu, hidden, "tanh", generator=torch.Generator().manual_seed(seed))
    return ac.to(dev)


def check_record(tag, rows, traj, rows_p, traj_p, rows_in, layout, nx, nu):
    """A policy kernel's rows and record against its plain version's on the
    same inputs; returns (largest absolute difference, share of record
    entries that differ at all)."""
    import torch

    err_rows = check_rows(tag, rows, rows_p, rows_in, layout)
    done, trunc = nx + nu + 1, nx + nu + 2
    exact = torch.equal(traj[:, [done, trunc]], traj_p[:, [done, trunc]])
    check(f"{tag}: done and truncation records", exact,
          f"{int(traj[:, done].sum())} vs {int(traj_p[:, done].sum())} dones, exact")
    err = max_err(traj, traj_p)
    close = bool(torch.isclose(traj, traj_p, rtol=K3_RTOL, atol=K3_ATOL).all())
    differ = float((traj != traj_p).double().mean())
    check(f"{tag}: whole record", close and bool(torch.isfinite(traj).all()),
          f"max_abs_err {err:.3g}, {differ:.3g} of entries not bit-equal "
          f"(rtol {K3_RTOL:g}, atol {K3_ATOL:g})")
    return max(err, err_rows), differ


# The policy kernels' widths checked against their plain versions: the
# rl_train width and the JAX kernels' largest (a run-time-width instance).
POLICY_WIDTHS = (HIDDEN, 128)


def check_policy(tag, fp, kernel, plain, layout, nx, nu, hidden, group=None):
    """A policy kernel against its plain version at ``fp``'s batch over
    CHECK_STEPS steps from fresh rows, weights of width ``hidden``, with
    ``group`` lanes per env where the kernel takes a group (None: its
    plan's)."""
    import torch

    from safe_control_gym_torch.parallel import fast_policy as P

    rows0 = fp.reset(seed=0)
    ac = seeded_ac(rows0.device, nx=nx, nu=nu, hidden=hidden)
    w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
    seed = torch.tensor([7], dtype=torch.int32, device=rows0.device)
    rows, traj = kernel(fp.params, rows0, w, seed, **({} if group is None else {"group": group}))
    rows_p, traj_p = plain(fp.params, rows0, w, seed)
    torch.cuda.synchronize()
    g = "" if group is None else f", G={group}"
    return check_record(f"{tag} vs plain (H={hidden}, B={fp.B}{g}, {CHECK_STEPS} steps)", rows,
                        traj, rows_p, traj_p, rows0, layout, nx, nu)


def check_policy_groups(tag, make_fp, kernel, plain, layout, nx, nu, groups, lanes):
    """A grouped policy kernel (K6, K8) against its plain version at both
    widths of POLICY_WIDTHS: at every built group at RAGGED_B, and at the
    planned group at RAGGED_B, CHECK_B and the batches where the plan picks
    its other groups (plan_batches).  Returns (largest absolute difference,
    largest share of record entries not bit-equal)."""
    errs = []
    for h in POLICY_WIDTHS:
        for B, group in ([(RAGGED_B, g) for g in groups]
                         + [(B, None) for B in (RAGGED_B, CHECK_B, *plan_batches(groups, lanes))]):
            errs.append(check_policy(tag, make_fp(B, h), kernel, plain, layout, nx, nu, h, group))
    return max(e for e, _ in errs), max(d for _, d in errs)


def phase_k3(dev):
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_policy as P

    env = make_quadrotor(cfg4(episode_len_sec=0.2, normalized_rl_action_space=True), device=dev)
    errs = [check_policy("K3", P.FastPolicyRollout(env, B, CHECK_STEPS, mlp_hidden=h, device=dev),
                         P.policy_rollout, P.policy_rollout_plain, K2_LAYOUT, 12, 4, h)
            for h in POLICY_WIDTHS for B in (CHECK_B, RAGGED_B)]
    return max(e for e, _ in errs), max(d for _, d in errs)


def check_policy_bits(tag, fp, kernel, plain, nx, nu):
    """A policy kernel's observation instance against its plain version bit
    for bit over CHECK_STEPS steps from fresh rows, under a policy whose
    layers are 0 (logstd seeded): the MLP's tanh, the one function whose
    libdevice and PyTorch roundings may differ, out of the way, the
    observation noise, goal rows, terminal observations, Gaussian sample and
    steps are held bit for bit.  Returns the truncated steps seen."""
    import torch

    from safe_control_gym_torch.parallel import fast_policy as P

    rows0 = fp.reset(seed=0)
    ac = seeded_ac(rows0.device, nx=nx, nu=nu)
    with torch.no_grad():
        for prm in list(ac.actor.parameters()) + list(ac.critic.parameters()):
            prm.zero_()
    w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
    seed = torch.tensor([7], dtype=torch.int32, device=rows0.device)
    rows, traj = kernel(fp.params, rows0, w, seed)
    rows_p, traj_p = plain(fp.params, rows0, w, seed)
    torch.cuda.synchronize()
    trunc = int(traj[:, nx + nu + 2].sum())
    differ = float((traj.view(torch.int32) != traj_p.view(torch.int32)).double().mean())
    same_rows = torch.equal(rows.view(torch.int32), rows_p.view(torch.int32))
    check(f"{tag} vs plain bit for bit (zero-weight policy, B={fp.B}, {CHECK_STEPS} steps)",
          same_rows and differ == 0.0 and trunc > 0,
          f"rows equal {same_rows}; {differ:.3g} of record entries differ; {trunc} truncated "
          "steps")
    return trunc


def phase_obs_ext(dev):
    """The policy kernels' observation instances against their plain
    versions at B = 1024 and the ragged 1000, H = 64 and 128, over CHECK_STEPS steps
    through resets and truncations: K3 on config 4-GH, K8 on 2D
    stabilization and 2D tracking with two goal-horizon blocks, K6 on
    cartpole_stab, all with the observation noise; with seeded weights at
    the record tolerance (done and truncation exact), and with a zero-weight
    policy bit for bit, with and without the noise."""
    from safe_control_gym_torch.envs.cartpole import make_cartpole
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_cartpole as FC
    from safe_control_gym_torch.parallel import fast_policy as P
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    cases = [("K3 (config 4-GH)", "k3", lambda noise: make_quadrotor(cfg4_gh(
                  noise, episode_len_sec=0.2), device=dev), P.FastPolicyRollout,
              P.policy_rollout, P.policy_rollout_plain, K2_LAYOUT, 4)]
    for task, extra in (("stabilization", {}), ("tracking", TRACK_CIRCLE)):
        cases.append((f"K8 2D (h=2, {task})", "k8", lambda noise, extra=extra: make_quadrotor(
            cfg_quad2d_gh(episode_len_sec=0.2, disturbances=OBS_NOISE if noise else None,
                          **extra), device=dev), PQ.FastPlanarQuadPolicyRollout,
            PQ.planar_policy_rollout, PQ.planar_policy_rollout_plain, k7_layout(6), 2))
    cases.append(("K6 (observation noise)", "k6", lambda noise: make_cartpole(cfg_cartpole_rl(
        episode_len_sec=0.2, disturbances=OBS_NOISE if noise else None), device=dev),
        FC.FastCartPolePolicyRollout, FC.cartpole_policy_rollout,
        FC.cartpole_policy_rollout_plain, K5_LAYOUT, 1))
    res = {}
    for tag, key, make_env, engine, kernel, plain, layout, nu in cases:
        env = make_env(True)
        errs = []
        for h in POLICY_WIDTHS:
            for B in (CHECK_B, RAGGED_B):
                fp = engine(env, B, CHECK_STEPS, mlp_hidden=h, device=dev)
                errs.append(check_policy(tag, fp, kernel, plain, layout, fp.obs_dim, nu, h))
        for noise in (True, False):
            env_b = env if noise else make_env(False)
            fp = engine(env_b, CHECK_B, CHECK_STEPS, device=dev)
            if noise or fp.obs_dim > layout_nx(layout):
                check_policy_bits(f"{tag}{'' if noise else ', noise off'}", fp, kernel, plain,
                                  fp.obs_dim, nu)
        err, differ = max(e for e, _ in errs), max(d for _, d in errs)
        res[f"{key}_obs_err"] = max(res.get(f"{key}_obs_err", 0.0), err)
        res[f"{key}_obs_differ"] = max(res.get(f"{key}_obs_differ", 0.0), differ)
    return res


def check_record_bits(tag, rows, traj, rows_p, traj_p):
    """A policy kernel's rows and record against its plain version's, every
    entry bit for bit; returns the largest absolute difference."""
    import torch

    same_rows = torch.equal(rows.view(torch.int32), rows_p.view(torch.int32))
    differ = float((traj.view(torch.int32) != traj_p.view(torch.int32)).double().mean())
    check(f"{tag}: rows and record bit for bit", same_rows and differ == 0.0
          and bool(torch.isfinite(traj).all()),
          f"rows equal {same_rows}; {differ:.3g} of {traj.numel()} record entries differ")
    return max(max_err(rows, rows_p), max_err(traj, traj_p))


def k3_maze_run(fp, hidden, seed=7):
    """K3's maze instance and its plain version on ``fp``'s fresh rows, with
    seeded weights of width ``hidden``; returns (rows_in, weights, seed,
    kernel (rows, traj), plain (rows, traj), the plain call's ms)."""
    import torch

    from safe_control_gym_torch.parallel import fast_policy as P

    rows0 = fp.reset(seed=0)
    ac = seeded_ac(rows0.device, nx=fp.obs_dim, hidden=hidden)
    w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
    sd = torch.tensor([seed], dtype=torch.int32, device=rows0.device)
    out = P.policy_rollout(fp.params, rows0, w, sd)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = P.policy_rollout_plain(fp.params, rows0, w, sd)
    end.record()
    torch.cuda.synchronize()
    return rows0, w, sd, out, ref, start.elapsed_time(end)


def phase_k3_maze(dev):
    """K3's maze instances (config 5, the competition maze, on K3).  The
    main path at full width: ``FastPolicyRollout`` on config 5 with the
    normalized action space and its step noise, B = 4096, T = 128, H = 64
    (and again at H = 128), seeded weights, one call through ``run`` with
    the launch counters zeroed just before and read just after, held
    against the plain version bit for bit (rows and record), its
    auto-resets and truncations counted, and timed.  Then at RAGGED_B and
    CHECK_B, H = 64 and 128 (K3 is built for one group of 8 lanes, the
    plan's at every B), with the observation white noise and with goal rows
    (the maze's observation instance), all bit for bit; and one K3 step on
    config 5 without noise under a logstd of -20 against the general engine
    driven by the same policy's means from MAZE_CROSS_B scattered and
    placed states (phase_maze_cross's)."""
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_policy as P
    from safe_control_gym_torch.parallel.vector import make_vec_env

    res, err = {}, 0.0
    env = make_quadrotor(cfg5(normalized_rl_action_space=True), device=dev)
    for h in POLICY_WIDTHS:
        fp = P.FastPolicyRollout(env, B_MAIN, TRAIN_T, mlp_hidden=h, device=dev)
        rows0, w, sd, (rows, traj), (rows_p, traj_p), plain_ms = k3_maze_run(fp, h)
        tag = f"K3 maze instance (config 5, B={B_MAIN}, T={TRAIN_T}, H={h})"
        err = max(err, check_record_bits(tag, rows, traj, rows_p, traj_p))
        r = {"plain_ms": plain_ms, "resets": float(rows[21].sum() - rows0[21].sum()),
             "truncations": float(traj[:, fp.obs_dim + 4 + 2].sum())}
        check(f"{tag}: episodes end in the call", r["resets"] > 0,
              f"{r['resets']:.0f} auto-resets, {r['truncations']:.0f} truncations")
        zero_counters()
        fp.run(rows0, w, seed=sd)
        torch.cuda.synchronize()
        r["launches"] = read_counters()
        check(f"{tag}: the call went through the maze instance",
              r["launches"]["k3_maze"] == 1 and r["launches"]["k3"] == 1
              and sum(r["launches"].values()) == 2, f"launches {r['launches']}")
        r["ms"] = device_ms(lambda: P.policy_rollout(fp.params, rows0, w, sd), 5)
        res[str(h)] = r

    # -- the ragged and check batches, and the maze's observation instance.
    small = make_quadrotor(cfg5(normalized_rl_action_space=True, episode_len_sec=4), device=dev)
    cases = [(f"H={h}, B={B}", small, h, B) for h in POLICY_WIDTHS for B in (RAGGED_B, CHECK_B)]
    for extra, kw in (("observation noise", dict(disturbances={**cfg5().disturbances, **OBS_NOISE})),
                      ("goal rows", dict(cost="rl_reward", obs_goal_horizon=2))):
        cases.append((f"{extra}, H={HIDDEN}, B={RAGGED_B}", make_quadrotor(cfg5(
            normalized_rl_action_space=True, episode_len_sec=4, **kw), device=dev), HIDDEN,
            RAGGED_B))
    for what, e, h, B in cases:
        fpc = P.FastPolicyRollout(e, B, 2 * CHECK_STEPS, mlp_hidden=h, device=dev)
        _, _, _, (r, t), (rp, tpl), _ = k3_maze_run(fpc, h)
        err = max(err, check_record_bits(
            f"K3 maze instance ({what}, obs {fpc.obs_dim}, {2 * CHECK_STEPS} steps)", r, t, rp, tpl))
    res["max_abs_err"] = err
    sd = torch.tensor([7], dtype=torch.int32, device=dev)

    # -- against the general engine: one step from scattered and placed
    # states, config 5 without noise, the policy's means.
    B = MAZE_CROSS_B
    env = make_quadrotor(cfg5(normalized_rl_action_space=True, episode_len_sec=4,
                              disturbances=None, randomized_inertial_prop=False,
                              init_state_randomization_info=MAZE_SCATTER,
                              done_on_completion=True), device=dev)
    state, obs, _ = make_vec_env(env, B).reset(seed=3)
    x, cur, at_goal = state.x.clone(), state.current_gate.clone(), state.steps_at_goal.clone()
    x[:96] = 0.0
    x[:64, 0], x[:64, 2], x[:64, 4] = (state.gates_eff[:64, 0, k] for k in (0, 1, 3))
    x[64:96, 0], x[64:96, 2], x[64:96, 4] = (float(env.x_goal[k]) for k in (0, 2, 4))
    cur[64:96], at_goal[64:96] = len(env.config.gates), 2 * env.config.ctrl_freq
    full = torch.full_like(cur, 40)
    state = state.replace(x=x, ctrl_step=full, pyb_step=2 * full, current_gate=cur,
                          steps_at_goal=at_goal)
    fpx = P.FastPolicyRollout(env, B, 1, device=dev)
    ac = seeded_ac(dev)
    with torch.no_grad():
        ac.logstd.fill_(-20.0)
    rows_in = fpx.pack(state)
    rows, traj = P.policy_rollout(fpx.params, rows_in, P.pack_weights(ac.actor, ac.critic,
                                                                      ac.logstd), sd)
    with torch.no_grad():
        s1, _, rew, done, _ = env.step(state, ac.actor(state.x))
    torch.cuda.synchronize()
    d = fpx.unpack_traj(traj)
    check("K3 maze vs general engine: done", torch.equal(d["done"][0] > 0.5, done),
          f"{int(d['done'][0].sum())} vs {int(done.sum())} of {B} done")
    rew_err = max_err(d["rew"][0], rew)
    check("K3 maze vs general engine: reward", rew_err <= 1e-4, f"max_abs_err {rew_err:.3g} (1e-4)")
    live = ~done
    cross = max_err(rows[:12, live].T, s1.x[live])
    check("K3 maze vs general engine: states of the envs not done",
          bool(torch.isclose(rows[:12, live].T, s1.x[live], rtol=2e-4, atol=2e-5).all()),
          f"max_abs_err {cross:.3g} (rtol 2e-4, atol 2e-5)")
    mz = 27 + 4 * fpx.params["n_gates"] + 2 * fpx.params["n_obstacles"]
    passed = int(s1.stepped_through_gate[:64].sum())
    check("K3 maze vs general engine: gate and goal counters",
          torch.equal(rows[mz, live], s1.current_gate[live].float())
          and torch.equal(rows[mz + 1, live], s1.steps_at_goal[live].float()) and passed == 64
          and bool(done[64:96].all()), f"exact; {passed} of 64 placed envs passed their gate")
    res["max_abs_err_vs_general_engine"] = cross
    return res


# The env-surface phase: config 4 with the aero modes (ground effect, drag,
# downwash), and config 4 with a quadratic state constraint (a sphere of
# radius 2 around the origin in position), a periodic dynamics force beside
# its impulse, and an adversary force on the dynamics channel.
SURFACE_STEPS = 32
QUAD_SPHERE = {"constraint_form": "quadratic_constraint", "constrained_variable": "state",
               "P": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], "b": 4.0,
               "active_dims": [0, 2, 4]}
PERIODIC = {"disturbance_func": "periodic", "scale": 0.002, "frequency": 1.5}


def surface_configs():
    """(tag, config, whether it goes through K1) of phase_env_surface."""
    c4 = cfg4()
    return [("config 4, pyb_gnd_drag_dw", cfg4(physics="pyb_gnd_drag_dw"), False),
            ("config 4, quadratic constraint, periodic force, adversary",
             cfg4(constraints=c4.constraints + (QUAD_SPHERE,),
                  disturbances={"dynamics": c4.disturbances["dynamics"] + (PERIODIC,)},
                  adversary_disturbance="dynamics", adversary_disturbance_scale=0.005), True)]


def surface_run(env, B, steps, seed=0):
    """``steps`` general-engine steps (make_vec_env, auto-reset) of ``env``
    at batch B from the port's seed-0 reset, under seeded thrusts around
    hover and, where the env has the adversary channel, a seeded adversary
    force set before each step; returns (final state, done flags of every
    step, host seconds of the steps)."""
    import torch

    from safe_control_gym_torch.parallel.vector import make_vec_env

    dev = env.device
    vec = make_vec_env(env, B)
    rng = np.random.default_rng(seed)
    hover = float(env.u_goal[0])
    acts = [torch.as_tensor((hover * (1 + 0.1 * rng.uniform(-1, 1, (B, 4)))).astype(np.float32),
                            device=dev) for _ in range(steps)]
    adv = [torch.as_tensor(rng.uniform(-1, 1, (B, 3)).astype(np.float32), device=dev)
           for _ in range(steps)]
    set_adv = env.extras["set_adversary_control"] if env.config.adversary_disturbance else None
    state, _, _ = vec.reset(seed=seed)
    dones = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        if set_adv is not None:
            state = set_adv(state, adv[t])
        state, _, _, done, _ = vec.step(state, acts[t])
        dones.append(done)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return state, torch.stack(dones), time.perf_counter() - t0


def phase_env_surface(dev):
    """The env surface on the card: the general engine at B = 4096 for
    SURFACE_STEPS steps on each of surface_configs(), with the launch
    counters zeroed just before and read just after (K1 not at all for the
    aero modes, once a step for the other), held against the same run of
    the port on the CPU (states rtol 2e-4 / atol 2e-5, done flags exact
    every step), and its host ms a step."""
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    res = {}
    for tag, cfg, through_k1 in surface_configs():
        env = make_quadrotor(cfg, device=dev)
        surface_run(env, B_MAIN, 2)  # warm-up
        zero_counters()
        state, dones, secs = surface_run(env, B_MAIN, SURFACE_STEPS)
        launches = read_counters()
        want = SURFACE_STEPS if through_k1 else 0
        check(f"{tag}: K1 launches", launches["k1"] == want
              and sum(launches.values()) == launches["k1"],
              f"launches {launches} in {SURFACE_STEPS} steps (want K1 {want})")
        ref_state, ref_dones, _ = surface_run(make_quadrotor(cfg, device="cpu"), B_MAIN,
                                              SURFACE_STEPS)
        x, x_ref = state.x.cpu(), ref_state.x
        err = max_err(x, x_ref)
        same_done = torch.equal(dones.cpu(), ref_dones)
        check(f"{tag}: card against the CPU ({SURFACE_STEPS} steps, B={B_MAIN})",
              same_done and bool(torch.isclose(x, x_ref, rtol=2e-4, atol=2e-5).all())
              and bool(torch.isfinite(x).all()),
              f"done flags equal {same_done} ({int(ref_dones.sum())} dones); states "
              f"max_abs_err {err:.3g} (rtol 2e-4, atol 2e-5)")
        res[tag] = {"host_ms_per_step": secs / SURFACE_STEPS * 1e3, "launches": launches,
                    "dones": int(ref_dones.sum()), "max_abs_err": err}
        print(f"  {tag}: {res[tag]['host_ms_per_step']:.3f} host ms a step at B={B_MAIN}; "
              f"{card_line()}", flush=True)
    return res


# The model-based base and PPO's leftovers (phase_lqr, phase_pid,
# phase_ppo_extras).  LQR's weights are tests/test_controllers.py's.
LQR_Q, LQR_R = [1.0], [0.1]
# The card's LQR gain table against the same code on the CPU, relative to
# the table's largest entry: both solve float32 Riccati equations whose
# solutions span several decades, and the two packages' float32 solutions
# already differ by up to 1e-3 there (tests/test_torch_linalg.py).
LQR_GAIN_REL = 5e-3
LQR_CPU_STEPS = 32  # closed-loop steps of config 4 held against the CPU
# tests/test_controllers.py:30-41 (CartPole) and :82-99 (the 3D quadrotor).
LQR_CARTPOLE = dict(task="stabilization", cost="quadratic", randomized_init=True,
                    episode_len_sec=5)
PID_QUAD3D = dict(quad_type=3, task="stabilization", cost="rl_reward",
                  task_info={"stabilization_goal": [0.3, -0.2, 1.0],
                             "stabilization_goal_tolerance": 0.05},
                  randomized_init=False, init_state={"init_z": 0.5}, episode_len_sec=4,
                  ctrl_freq=50, pyb_freq=100)
PID_BAR = 0.1  # m from the goal at the end of the episode (test_controllers.py:98)
# pid_control on the card against the CPU: the RPMs at rtol 2e-4 (gains of
# 7e4 on the attitude error turn a last-place difference of a rotation into
# ~1e-7 of an RPM), the PID state at the state tolerance.
PID_RTOL, PID_ATOL = 2e-4, 2e-5


def path_profile(step, steps=16):
    """Where ``steps`` calls of ``step`` (one general-engine step each) spend
    the device's time: wall (unprofiled), device busy, K1's device time a
    launch and its launches, from one profiled session."""
    import torch

    run = lambda: [step() for _ in range(steps)]  # noqa: E731
    _, kern = profile_kernels(run, 1)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(t for t, _ in kern.values())
    k1 = [(t, n) for k, (t, n) in kern.items() if "quad3d_substeps_kernel" in k]
    k1_ms, k1_n = sum(t for t, _ in k1), sum(n for _, n in k1)
    check(f"profile of {steps} steps holds K1", k1_n == steps, f"K1 launches seen {k1_n}")
    return {"steps": steps, "wall_ms": wall, "device_ms": busy, "busy_share": busy / wall,
            "k1_ms_per_launch": k1_ms / k1_n, "k1_device_share": k1_ms / busy,
            "kernel_launches": sum(n for _, n in kern.values()),
            "top": sorted(((k[:80], t, n) for k, (t, n) in kern.items()), key=lambda r: -r[1])[:5]}


def lqr_closed_loop(lqr, env, B, steps, seed=0):
    """``steps`` closed-loop steps of the LQR's gain table on ``env`` (no
    reset, as run_tracking); the final state and the done flags."""
    import torch

    from safe_control_gym_torch.parallel.vector import make_vec_env

    vec = make_vec_env(env, B, auto_reset=False)
    state, obs, _ = vec.reset(seed=seed)
    dones = []
    for k in range(steps):
        state, obs, _, done, _ = vec.step_no_reset(state, lqr._policy_at(obs, k))
        dones.append(done)
    return state, torch.stack(dones)


def phase_lqr(dev):
    """LQR on config 4 at B = 4096: the tracking gain table (one Riccati
    solve a waypoint, one batch) built on the card against the same code on
    the CPU (relative to the table's largest entry, LQR_GAIN_REL); three
    waypoints' DARE in float64 on the card against scipy (1e-8); one full
    run_tracking episode on the general engine with the launch counters
    zeroed just before and read just after (K1 once a step, nothing else),
    its host ms a step and tracking RMSE; the first LQR_CPU_STEPS steps of
    the closed loop against the CPU on the card's gain table (states rtol
    2e-4 / atol 2e-5, done flags exact).  Then run(analysis=True) of LQR on
    CartPole stabilization at B = 4096: every env at the goal within 0.05
    (tests/test_controllers.py:41), and env 0's state RMSE against the
    same run on the CPU."""
    import scipy.linalg
    import torch

    from safe_control_gym_torch.controllers.lqr import LQR
    from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.ops.integrators import discretize_linear_system
    from safe_control_gym_torch.ops.linalg import solve_discrete_are

    env, env_cpu = make_quadrotor(cfg4(), device=dev), make_quadrotor(cfg4(), device="cpu")
    build_s = []
    for _ in range(2):  # the first build loads the solver libraries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lqr = LQR(env, q_lqr=LQR_Q, r_lqr=LQR_R)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
    lqr_cpu = LQR(env_cpu, q_lqr=LQR_Q, r_lqr=LQR_R)
    K, K_cpu = lqr.gain.cpu(), lqr_cpu.gain
    gain_rel = float((K.double() - K_cpu.double()).abs().max() / K_cpu.abs().max())
    check("LQR gain table on the card against the CPU",
          K.shape == K_cpu.shape == (env.max_episode_steps, 4, 12) and bool(torch.isfinite(K).all())
          and gain_rel < LQR_GAIN_REL,
          f"{K.shape[0]} waypoint gains, largest difference {gain_rel:.3g} of the largest entry "
          f"(bound {LQR_GAIN_REL:g}); built in {build_s[0] * 1e3:.1f} ms on the card, "
          f"{build_s[1] * 1e3:.1f} ms the second time")

    ks = [0, K.shape[0] // 3, 2 * K.shape[0] // 3]
    x0 = lqr.x_0[ks].double()
    A, B = env.symbolic.batch_linearize(x0, lqr.u_0.double().expand(len(ks), -1))
    Ad, Bd = discretize_linear_system(A, B, env.symbolic.dt)
    Q, R = lqr.Q.double(), lqr.R.double()
    P = solve_discrete_are(Ad, Bd, Q, R).cpu().numpy()
    dare_rel = max(float(np.abs(P[i] - ref).max() / np.abs(ref).max())
                   for i, ref in enumerate(scipy.linalg.solve_discrete_are(
                       Ad[i].cpu().numpy(), Bd[i].cpu().numpy(), Q.cpu().numpy(),
                       R.cpu().numpy()) for i in range(len(ks))))
    check("float64 DARE of three waypoints on the card against scipy", dare_rel < 1e-8,
          f"waypoints {ks}: largest difference {dare_rel:.3g} of the largest entry (bound 1e-8)")

    lqr.run_tracking(num_episodes=B_MAIN, seed=1)  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    tracking = lqr.run_tracking(num_episodes=B_MAIN, seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters()
    steps = env.max_episode_steps
    rmse = tracking["rmse"]
    check("LQR run_tracking on config 4: K1 once a general-engine step",
          launches["k1"] == steps and sum(launches.values()) == steps,
          f"launches {launches} in {steps} steps at B={B_MAIN}")
    check("LQR run_tracking output", rmse.shape == (B_MAIN,) and bool(np.isfinite(rmse).all())
          and bool(np.isfinite(tracking["ep_returns"]).all()),
          f"tracking RMSE median {np.median(rmse):.4g} m (min {rmse.min():.4g}, max "
          f"{rmse.max():.4g}); mean return {tracking['ep_returns'].mean():.6g}")
    from safe_control_gym_torch.parallel.vector import make_vec_env

    vec = make_vec_env(env, B_MAIN, auto_reset=False)
    loop = dict(zip(("s", "o"), vec.reset(seed=0)[:2]))

    def step():
        loop["s"], loop["o"], _, _, _ = vec.step_no_reset(loop["s"], lqr._policy_at(loop["o"], 8))

    prof = path_profile(step)
    lqr_cpu.gain = K
    state, dones = lqr_closed_loop(lqr, env, B_MAIN, LQR_CPU_STEPS)
    state_c, dones_c = lqr_closed_loop(lqr_cpu, env_cpu, B_MAIN, LQR_CPU_STEPS)
    x, x_c = state.x.cpu(), state_c.x
    loop_err = max_err(x, x_c)
    same_done = torch.equal(dones.cpu(), dones_c)
    check(f"LQR closed loop on the card against the CPU ({LQR_CPU_STEPS} steps, B={B_MAIN})",
          same_done and bool(torch.isclose(x, x_c, rtol=2e-4, atol=2e-5).all()),
          f"done flags equal {same_done} ({int(dones_c.sum())} dones); states max_abs_err "
          f"{loop_err:.3g} (rtol 2e-4, atol 2e-5)")
    res = {"gain_rel_err": gain_rel, "gain_build_ms": [t * 1e3 for t in build_s],
           "dare_f64_rel_err": dare_rel,
           "launches": launches, "steps": steps,
           "host_ms_per_step": secs / steps * 1e3, "tracking_rmse_median": float(np.median(rmse)),
           "tracking_rmse_max": float(rmse.max()),
           "mean_return": float(tracking["ep_returns"].mean()), "closed_loop_max_abs_err": loop_err,
           "profile": prof}
    print(f"  LQR tracking, config 4: {res['host_ms_per_step']:.3f} host ms a general-engine step "
          f"at B={B_MAIN} ({steps} steps, K1 {launches['k1']}); profiled: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['device_ms']:.3f} ms in {prof['steps']} "
          f"steps, K1 {prof['k1_ms_per_launch'] * 1e3:.4f} us a launch; {card_line()}", flush=True)

    cp = make_cartpole(CartPoleConfig(**LQR_CARTPOLE), device=dev)
    cp_lqr = LQR(cp, q_lqr=LQR_Q, r_lqr=LQR_R)
    cp_lqr.run(num_episodes=B_MAIN, seed=1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cp_lqr.run(num_episodes=B_MAIN, seed=0, analysis=True)
    torch.cuda.synchronize()
    cp_secs = time.perf_counter() - t0
    cp_cpu = make_cartpole(CartPoleConfig(**LQR_CARTPOLE), device="cpu")
    ref = LQR(cp_cpu, q_lqr=LQR_Q, r_lqr=LQR_R).run(num_episodes=B_MAIN, seed=0, analysis=True)
    an, an_ref = out["analysis"], ref["analysis"]
    final = np.abs(out["obs"][-1]).max(-1)
    check(f"LQR run(analysis=True), CartPole stabilization (B={B_MAIN})",
          an["state_rmse"].shape == (4,) and bool(np.isfinite(an["state_rmse"]).all())
          and bool((final < 0.05).all())
          and np.allclose(an["state_rmse"], an_ref["state_rmse"], rtol=2e-4, atol=2e-5),
          f"env 0 state_rmse {np.round(an['state_rmse'], 5).tolist()} (CPU "
          f"{np.round(an_ref['state_rmse'], 5).tolist()}, rtol 2e-4, atol 2e-5); every env at "
          f"the goal within 0.05: largest final |state| {final.max():.4g}")
    res["cartpole"] = {"state_rmse": an["state_rmse"].tolist(),
                       "state_rmse_scalar": an["state_rmse_scalar"],
                       "host_ms_per_step": cp_secs / cp.max_episode_steps * 1e3,
                       "final_max_abs": float(final.max())}
    print(f"  LQR run(analysis=True), CartPole: {res['cartpole']['host_ms_per_step']:.3f} host ms "
          f"a step at B={B_MAIN}; {card_line()}", flush=True)
    return res


def pid_random_inputs(B, dev, seed=0):
    """Seeded random PID state and inputs (B, 3) for pid_control."""
    import torch

    from safe_control_gym_torch.controllers.pid import PIDState

    rng = np.random.default_rng(seed)

    def f(scale, shift=(0.0, 0.0, 0.0)):
        return torch.as_tensor((rng.standard_normal((B, 3)) * scale + shift).astype(np.float32),
                               device=dev)

    state = PIDState(f(0.1), f(0.1), f(0.2))
    return state, dict(cur_pos=f(0.5, (0, 0, 1)), cur_rpy=f(0.2), cur_vel=f(0.3),
                       target_pos=f(0.5, (0, 0, 1)), target_rpy=f(0.3), target_vel=f(0.2),
                       target_rpy_rates=f(0.1))


def phase_pid(dev):
    """The PID on B = 4096 3D quadrotors (tests/test_controllers.py:82-99:
    goal (0.3, -0.2, 1.0), 50 Hz control, 100 Hz physics, 4 s): the batched
    ``PID.act`` (pid_control over the batch) and the general engine for a
    whole episode with the launch counters zeroed just before and read just
    after (K1 once a step, nothing else); every env ends within PID_BAR of
    the goal; its host ms a step.  Then one batched pid_control step on
    seeded random inputs on the card against the CPU (RPMs rtol PID_RTOL;
    the PID state and errors rtol PID_RTOL / atol PID_ATOL)."""
    import torch

    from safe_control_gym_torch.controllers.pid import PID, PIDState, pid_control
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.parallel.vector import make_vec_env

    env = make_quadrotor(QuadrotorConfig(**PID_QUAD3D), device=dev)
    pid = PID(env)
    vec = make_vec_env(env, B_MAIN, auto_reset=False)

    def episode(steps):
        state, obs, _ = vec.reset(seed=0)
        ps = PIDState.create((B_MAIN,), device=dev)
        for k in range(steps):
            act, ps = pid.act(obs, k, ps)
            state, obs, _, _, _ = vec.step_no_reset(state, act)
        return state

    episode(2)  # warm-up
    steps = env.max_episode_steps
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    state = episode(steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters()
    check("PID on the 3D quad: K1 once a general-engine step",
          launches["k1"] == steps and sum(launches.values()) == steps,
          f"launches {launches} in {steps} steps at B={B_MAIN}")
    goal = torch.tensor([0.3, -0.2, 1.0], device=dev)
    err = (state.x[:, [0, 2, 4]] - goal).norm(dim=-1).cpu()
    check(f"PID: every env within {PID_BAR} m of the goal after {steps} steps",
          bool(torch.isfinite(err).all()) and float(err.max()) < PID_BAR,
          f"largest distance {float(err.max()):.4g} m, median {float(err.median()):.4g} m")

    obs0 = vec.reset(seed=0)[:2]
    loop = {"s": obs0[0], "o": obs0[1], "p": PIDState.create((B_MAIN,), device=dev)}

    def step():
        act, loop["p"] = pid.act(loop["o"], 8, loop["p"])
        loop["s"], loop["o"], _, _, _ = vec.step_no_reset(loop["s"], act)

    prof = path_profile(step)

    ps, inp = pid_random_inputs(B_MAIN, dev)
    rpm, new, pos_e, yaw_e = pid_control(ps, pid.dt, **inp)
    ps_c = PIDState(*(t.cpu() for t in (ps.integral_pos_e, ps.integral_rpy_e, ps.last_rpy)))
    rpm_c, new_c, pos_e_c, yaw_e_c = pid_control(ps_c, pid.dt,
                                                  **{k: v.cpu() for k, v in inp.items()})
    rpm_err = max_err(rpm.cpu(), rpm_c)
    pairs = ((new.integral_pos_e, new_c.integral_pos_e), (new.integral_rpy_e, new_c.integral_rpy_e),
             (pos_e, pos_e_c), (yaw_e, yaw_e_c))
    state_err = max(max_err(a.cpu(), b) for a, b in pairs)
    check(f"pid_control on the card against the CPU (B={B_MAIN}, random inputs)",
          bool(torch.isclose(rpm.cpu(), rpm_c, rtol=PID_RTOL, atol=0.0).all())
          and all(bool(torch.isclose(a.cpu(), b, rtol=PID_RTOL, atol=PID_ATOL).all())
                  for a, b in pairs),
          f"RPM max_abs_err {rpm_err:.3g} (rtol {PID_RTOL:g}; RPMs {float(rpm_c.min()):.0f}-"
          f"{float(rpm_c.max()):.0f}); state and errors max_abs_err {state_err:.3g} "
          f"(rtol {PID_RTOL:g}, atol {PID_ATOL:g})")
    res = {"launches": launches, "steps": steps, "host_ms_per_step": secs / steps * 1e3,
           "final_dist_max": float(err.max()), "rpm_max_abs_err": rpm_err,
           "state_max_abs_err": state_err, "profile": prof}
    print(f"  PID, 3D quad: {res['host_ms_per_step']:.3f} host ms a general-engine step at "
          f"B={B_MAIN} ({steps} steps, K1 {launches['k1']}); profiled: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['device_ms']:.3f} ms in {prof['steps']} "
          f"steps, K1 {prof['k1_ms_per_launch'] * 1e3:.4f} us a launch; {card_line()}", flush=True)
    return res


PPO_EXTRAS_STEPS = 2  # train steps of each update path (the first warms up)
CNN_IMAGE = (84, 84, 4)  # a Nature-DQN frame stack
RNN_SHAPE = (256, 32, 12, 64)  # B, T, D, H


def phase_ppo_extras(dev):
    """PPO's leftovers on the card: config 4 at the rl_train shapes (K3
    collection) with ``fused_update=True`` against the separate autograd
    update (``use_fast_update=False``) from one seed, PPO_EXTRAS_STEPS train
    steps each, the parameters after them within the gradient tolerance
    (rtol 2e-4 / atol 1e-6, tests/test_rl.py:193), K3 once a train step and
    K4 never; then the CNN, the RNN with masks and the Categorical forward
    on the card against the CPU from the same seeded weights and inputs
    (CNN rtol 1e-4 / atol 1e-5; RNN rtol 2e-4 / atol 2e-5; Categorical rtol
    1e-5 / atol 1e-6, the mode exactly)."""
    import torch

    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.models.distributions import Categorical
    from safe_control_gym_torch.models.networks import CNN, RNN

    env = make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev)
    res, params, initial = {}, {}, None
    for fused in (False, True):
        tag = "fused" if fused else "separate"
        ppo = PPO(env, seed=0, rollout_batch_size=TRAIN_B, rollout_steps=TRAIN_T,
                  opt_epochs=EPOCHS, mini_batch_size=MB, use_fast_rollout=True,
                  use_fast_update=False, fused_update=fused, reshuffle_each_epoch=False)
        initial = initial or [p.detach().cpu().clone() for p in ppo.state.ac.parameters()]
        ppo.state, _ = ppo._train_step(ppo.state)
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        ppo.state, metrics = ppo.train_many(PPO_EXTRAS_STEPS - 1)(ppo.state)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counters()
        n = PPO_EXTRAS_STEPS - 1
        check(f"config 4, {tag} update: K3 collects, K4 idle",
              launches["k3"] == n and sum(launches.values()) == n
              and all(np.isfinite(float(v)) for v in metrics.values()),
              f"launches {launches} in {n} train step(s); metrics "
              f"{ {k: round(float(v), 6) for k, v in metrics.items()} }")
        params[fused] = [p.detach().cpu() for p in ppo.state.ac.parameters()]
        res[tag] = {"train_step_ms": secs / n * 1e3, "launches": launches}
    err = max(max_err(a, b) for a, b in zip(params[True], params[False]))
    moved = max(max_err(a, b) for a, b in zip(params[False], initial))
    check(f"fused update against the separate update ({PPO_EXTRAS_STEPS} train steps at the "
          "rl_train shapes)",
          all(bool(torch.isclose(a, b, rtol=2e-4, atol=1e-6).all())
              for a, b in zip(params[True], params[False])) and moved > 1e-4,
          f"parameters max_abs_err {err:.3g} (rtol 2e-4, atol 1e-6); the update moved them by "
          f"up to {moved:.3g}")
    res["max_abs_err"] = err
    print(f"  PPO train step, config 4, B={TRAIN_B}, T={TRAIN_T}: fused update "
          f"{res['fused']['train_step_ms']:.3f} ms, separate autograd update "
          f"{res['separate']['train_step_ms']:.3f} ms; {card_line()}", flush=True)

    rng = np.random.default_rng(0)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    cnn = CNN(CNN_IMAGE, 6, generator=gen())
    img = torch.as_tensor(rng.random((256, *CNN_IMAGE)).astype(np.float32))
    B, T, D, H = RNN_SHAPE
    rnn = RNN(D, H, generator=gen())
    xs = torch.as_tensor(rng.standard_normal((B, T, D)).astype(np.float32))
    masks = torch.as_tensor((rng.random((B, T)) > 0.1).astype(np.float32))
    logits = torch.as_tensor((2.0 * rng.standard_normal((B_MAIN, 6))).astype(np.float32))
    value = torch.as_tensor(rng.integers(0, 6, B_MAIN))
    with torch.no_grad():
        want_cnn = cnn(img)
        want_ys, want_h = rnn(xs, masks)
        cnn_d, rnn_d = cnn.to(dev), rnn.to(dev)
        got_cnn = cnn_d(img.to(dev)).cpu()
        got_ys, got_h = (t.cpu() for t in rnn_d(xs.to(dev), masks.to(dev)))
    cnn_err, rnn_err = max_err(got_cnn, want_cnn), max(max_err(got_ys, want_ys),
                                                       max_err(got_h, want_h))
    check(f"CNN forward on the card against the CPU ({tuple(img.shape)} images)",
          got_cnn.shape == (256, 6) and bool(torch.isclose(got_cnn, want_cnn, rtol=1e-4,
                                                           atol=1e-5).all()),
          f"max_abs_err {cnn_err:.3g} (rtol 1e-4, atol 1e-5)")
    check(f"RNN forward with masks on the card against the CPU (B {B}, T {T}, D {D}, H {H})",
          bool(torch.isclose(got_ys, want_ys, rtol=2e-4, atol=2e-5).all())
          and bool(torch.isclose(got_h, want_h, rtol=2e-4, atol=2e-5).all()),
          f"max_abs_err {rnn_err:.3g} (rtol 2e-4, atol 2e-5)")
    cat, cat_d = Categorical(logits), Categorical(logits.to(dev))
    pairs = ((cat_d.log_prob(value.to(dev)), cat.log_prob(value)),
             (cat_d.entropy(), cat.entropy()))
    cat_err = max(max_err(a.cpu(), b) for a, b in pairs)
    draws = cat_d.sample(torch.Generator(device=dev).manual_seed(0))
    check(f"Categorical on the card against the CPU ({B_MAIN} x 6 logits)",
          all(bool(torch.isclose(a.cpu(), b, rtol=1e-5, atol=1e-6).all()) for a, b in pairs)
          and torch.equal(cat_d.mode().cpu(), cat.mode()) and draws.shape == (B_MAIN,)
          and int(draws.min()) >= 0 and int(draws.max()) < 6,
          f"log_prob and entropy max_abs_err {cat_err:.3g} (rtol 1e-5, atol 1e-6), mode exact, "
          f"{B_MAIN} draws in range")
    res.update(cnn_max_abs_err=cnn_err, rnn_max_abs_err=rnn_err, categorical_max_abs_err=cat_err)
    return res


# The model-based stack (phase_mpc_solve, phase_mpc, phase_ilqr,
# phase_linear_mpc, phase_gp_mpc, phase_cbf): batched AL-iLQR solves on the
# card, the 3D closed loop through K1, each against the same code on the CPU.
MPC_SOLVE_B, MPC_H = 1024, 20  # benchmarks/mpc_solve.py's batch and horizon
MPC_SOLVE_REPS, MPC_SINGLE_REPS = 1, 1
MPC_CPU_ENVS = 8  # envs of a card solve held against the CPU
# A card solve against the CPU's: float32 with other rounding (cuBLAS
# products, CUDA's reciprocal division by a scalar), so the solves' accept
# decisions between costs equal to the last place fall apart as they do
# between the two packages.  Each limit (costs rtol, inputs over their
# largest) sits between the sound readings and the smallest reading with a
# fault planted, both from scripts/mpc_tolerance_port.py over five seeds on
# an H100 (run T13, PERF.md §6):
# - the 2D solve (phase_mpc_solve): sound <= 1.71e-7 and 9.03e-4; the input
#   box left out >= 2.04e-3 and 0.255;
# - the 3D loop's solves (phase_mpc): sound <= 6.33e-5 and 6.69e-3; one
#   inner iteration fewer or the input box left out >= 0.205 and 0.719;
# - GP-MPC's solves (phase_gp_mpc): sound <= 2.43e-3 and 1.33e-2; the GP
#   mean left out >= 7.62e-2 and 4.67e-2.  The margins left out read as the
#   sound solves (no row near its bound): the margins check sees them.
MPC_COST_RTOL, MPC_US_REL = 2e-5, 1e-2
MPC3D_COST_RTOL, MPC3D_US_REL = 1e-3, 1e-2
GP_COST_RTOL, GP_US_REL = 1e-2, 2.5e-2
# The 3D loop runs 50 of tests/test_controllers.py's 150 steps (cut to keep
# chip_smoke.py inside its time with the competition phases): its
# bar at step 150 (median final position error <= 0.06 m, >= 95% within
# 0.1 m) becomes progress at step 50: the median position error at most
# MPC_BAR_MEDIAN m and at most MPC_BAR_FALL of its value after the first
# step.  A CPU run of this loop (B = 64, seeds 0..63 of the same draw) read
# 0.696 m after step 1, 0.385 at step 50 (0.55 of it) and 0.0494 at step
# 150, so both limits sit above the reading with room for the card's
# float32 drift.
MPC_STEPS, MPC_CPU_STEPS, MPC_CPU_B = 50, 3, 32
MPC_BAR_MEDIAN, MPC_BAR_FALL = 0.45, 0.65
# The 3D PID config (tests/test_controllers.py:82-99) as an MPC task.
MPC_QUAD3D = dict(PID_QUAD3D, cost="quadratic", randomized_init=True,
                  constraints=({"constraint_form": "default_constraint",
                                "constrained_variable": "input"},))
ILQR_CARTPOLE = dict(task="stabilization", cost="quadratic", randomized_init=False,
                     init_state={"init_theta": 0.2, "init_x": -0.3}, episode_len_sec=4)
ILQR_COST_RTOL = 1e-3
LMPC_QUAD2D = dict(quad_type=2, task="stabilization", cost="quadratic",
                   task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.01},
                   randomized_init=False, init_state={"init_x": 0.3, "init_z": 0.6},
                   episode_len_sec=3, ctrl_freq=50, pyb_freq=50)
LMPC_B = 256
# tests/test_gp_mpc.py:103-118 (the env's mass is not the prior's) with the
# mixed constraint rows of tests/test_gp_mpc.py:26-37, so that the margins
# exist and go through row_order.
GP_QUAD2D = dict(quad_type=2, task="stabilization", cost="quadratic",
                 task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.01},
                 randomized_init=False, init_state={"init_z": 0.9},
                 inertial_prop={"M": 0.041, "Iyy": 1.4e-5}, episode_len_sec=2, ctrl_freq=25,
                 pyb_freq=50,
                 constraints=(
                     {"constraint_form": "quadratic_constraint", "constrained_variable": "state",
                      "P": np.diag([1.0, 0.2, 1.0, 0.2, 0.5, 0.1]).tolist(), "b": 25.0},
                     {"constraint_form": "default_constraint", "constrained_variable": "input"},
                     {"constraint_form": "symmetric_constraint", "constrained_variable": "state",
                      "bound": [2.0, 2.0], "active_dims": [0, 2]},
                     {"constraint_form": "linear_constraint", "constrained_variable": "state",
                      "A": np.eye(6).tolist(), "b": [3.0] * 6}))
GP_B, GP_STEPS = 8, 10
MPC_QUAD3D_KW = dict(horizon=MPC_H, q_mpc=[1.0], r_mpc=[0.1], al_iters=2, inner_iters=3,
                     terminal_lqr_cost=True)
GP_KW = dict(horizon=10, q_mpc=[1.0], r_mpc=[0.1], num_samples=150, num_inducing=40,
             gp_iters=80, al_iters=1, inner_iters=4, terminal_lqr_cost=True)
CBF_B = 4096
CBF_ATOL = 1e-4  # 200 ADMM iterations in float32 (tests/test_torch_cbf_qp.py's QP_ATOL)


def timed(fn, reps):
    """Mean host ms of ``reps`` calls of ``fn``, synchronized at the end."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def mpc_rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.abs().max())


def phase_mpc_solve(dev):
    """The benchmarks/mpc_solve.py workload (``baseline.cfg_mpc_solve``:
    2D quad stabilization to (0.5, 1.0), the input box; ``MPC(env,
    horizon=20)``, 3 AL x 6 inner iterations; B = 1024 initial states
    0.2 N(0, 1) from a seeded generator): one batched solve under
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises); its
    first MPC_CPU_ENVS problems against the same solve on the CPU (costs
    rtol MPC_COST_RTOL, inputs within MPC_US_REL of their largest); the
    launches and device time of one batched solve (``profile_launches``),
    ms per batched solve and per single solve (host clock, synchronized)."""
    import torch

    from safe_control_gym_torch.baseline import cfg_mpc_solve
    from safe_control_gym_torch.controllers.mpc import MPC
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    mpc = MPC(make_quadrotor(cfg_mpc_solve(), device=dev), horizon=MPC_H)
    mpc_c = MPC(make_quadrotor(cfg_mpc_solve(), device="cpu"), horizon=MPC_H)
    gen = torch.Generator().manual_seed(0)
    x0s_c = 0.2 * torch.randn(MPC_SOLVE_B, mpc.model.nx, generator=gen)
    x0s = x0s_c.to(dev)
    t0 = time.perf_counter()
    mpc.solve_batch(x0s)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("error")
    try:
        us, cost = mpc.solve_batch(x0s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check("batched AL-iLQR solve without a host sync",
          tuple(us.shape) == (MPC_SOLVE_B, MPC_H, mpc.model.nu) and bool(torch.isfinite(us).all())
          and bool(torch.isfinite(cost).all()),
          f"B={MPC_SOLVE_B}, H={MPC_H}: one solve under set_sync_debug_mode('error'); "
          f"costs {float(cost.min()):.5g}-{float(cost.max()):.5g}")
    cost_err, us_err = solve_errs(us, cost, *mpc_c.solve_batch(x0s_c[:MPC_CPU_ENVS]))
    check(f"MPC solve on the card against the CPU (first {MPC_CPU_ENVS} envs)",
          cost_err < MPC_COST_RTOL and us_err < MPC_US_REL,
          f"costs rel {cost_err:.3g} (rtol {MPC_COST_RTOL:g}); inputs {us_err:.3g} of the "
          f"largest (bound {MPC_US_REL:g})")
    batched_ms, _ = timed(lambda: mpc.solve_batch(x0s), MPC_SOLVE_REPS)
    single = {"i": 0}

    def one():
        single["i"] += 1
        return mpc.solve_batch(x0s[single["i"]][None])

    single_ms, _ = timed(one, MPC_SINGLE_REPS)
    launches, busy, top = profile_launches(lambda: mpc.solve_batch(x0s))
    check("a profiled batched solve launched on the card", launches > 0 and busy > 0,
          f"{launches} device operations, {busy:.3f} device ms")
    res = {"batch": MPC_SOLVE_B, "horizon": MPC_H, "first_solve_s": first_s,
           "batched_ms": batched_ms, "single_ms": single_ms,
           "solves_per_s": MPC_SOLVE_B / batched_ms * 1e3, "launches_per_solve": launches,
           "device_ms_per_solve": busy, "cpu_cost_rel_err": cost_err, "cpu_us_rel_err": us_err,
           "top": top}
    print(f"  MPC solve (2D quad, B={MPC_SOLVE_B}, H={MPC_H}, 3x6 iterations): "
          f"{batched_ms:.2f} ms a batched solve ({res['solves_per_s']:.6g} solves/s), "
          f"{single_ms:.2f} ms a single solve; profiled: {launches} launches (kernels, memsets, "
          f"copies) a batched solve, device busy {busy:.3f} ms; first solve {first_s:.2f} s; "
          f"{card_line()}",
          flush=True)
    return res


def mpc_loop(ctrl, env, steps, env_seeds, x0=None, record=0):
    """``steps`` closed-loop steps of ``ctrl.solve_batch`` on ``env`` from
    ``env_seeds`` (states replaced by ``x0`` where given), the first input
    clipped to the input box: the states after each step, and the first
    ``record`` solves' (observations, inputs, costs)."""
    import torch

    from safe_control_gym_torch.parallel.vector import make_vec_env

    vec = make_vec_env(env, env_seeds.shape[0], auto_reset=False)
    state, obs, _ = vec.reset(env_seeds=env_seeds)
    if x0 is not None:
        state, obs = state.replace(x=x0), x0
    xs, solves = [], []
    for k in range(steps):
        us, cost = ctrl.solve_batch(obs, k)
        if k < record:
            solves.append((obs, us, cost))
        act = torch.clamp(us[:, 0], ctrl._u_lo, ctrl._u_hi)
        state, obs, _, _, _ = vec.step_no_reset(state, act)
        xs.append(state.x)
    return xs, solves


def solve_errs(us, cost, us_c, cost_c):
    """A card solve against the CPU's on the CPU solve's envs (the first
    ones): (the costs' largest relative error, the inputs' largest error
    over their largest)."""
    n = cost_c.shape[0]
    return (float(((cost[:n].cpu().double() - cost_c.double()).abs()
                   / cost_c.double().abs()).max()), mpc_rel(us[:n].cpu(), us_c))


def redo_solves(ctrl_c, solves, n):
    """The recorded solves of a closed loop on the card (``mpc_loop``), redone
    by ``ctrl_c`` on the CPU from the same observations for the first ``n``
    envs: the largest ``solve_errs`` over the solves."""
    errs = [solve_errs(us, cost, *ctrl_c.solve_batch(obs[:n].cpu(), k))
            for k, (obs, us, cost) in enumerate(solves)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_solves(tag, ctrl_c, solves, n, cost_rtol, us_rel):
    """The recorded solves of a closed loop on the card, redone on the CPU
    solve by solve (a closed loop drifts once a float32 accept decision
    flips; ``redo_solves``): costs rtol ``cost_rtol``, inputs within
    ``us_rel`` of the largest."""
    cost_err, us_err = redo_solves(ctrl_c, solves, n)
    check(f"{tag}: {len(solves)} solves of the closed loop on the card against the CPU "
          f"({n} envs)", cost_err < cost_rtol and us_err < us_rel,
          f"costs rel {cost_err:.3g} (rtol {cost_rtol:g}); inputs {us_err:.3g} of the "
          f"largest (bound {us_rel:g})")
    return cost_err, us_err


def phase_mpc(dev):
    """The 3D quad closed loop with K1 on the path: the PID config of
    tests/test_controllers.py:82-99 with the input box, the quadratic cost
    and randomized initial states; ``MPC(horizon=20, q_mpc=[1],
    r_mpc=[0.1], al_iters=2, inner_iters=3, terminal_lqr_cost=True)``; B =
    1024 envs for MPC_STEPS steps of ``solve_batch`` -> clip -> the general
    engine, the launch counters zeroed just before and read just after (K1
    once a step, nothing else); the bar: median position error after the
    last step <= MPC_BAR_MEDIAN m and <= MPC_BAR_FALL of the median after
    the first; the solves of the first MPC_CPU_STEPS steps redone on the CPU for
    the first MPC_CPU_B envs (``check_solves`` at MPC3D_COST_RTOL,
    MPC3D_US_REL); a profile of two of the
    loop's env steps holds two K1 launches; K1's us a launch."""
    import torch

    from safe_control_gym_torch.controllers.mpc import MPC
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.ops import ctr_prng
    from safe_control_gym_torch.parallel.vector import make_vec_env

    env = make_quadrotor(QuadrotorConfig(**MPC_QUAD3D), device=dev)
    mpc = MPC(env, **MPC_QUAD3D_KW)
    seeds = ctr_prng.env_seeds_from_seed(0, MPC_SOLVE_B, dev)
    mpc_loop(mpc, env, 1, seeds)  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    xs, solves = mpc_loop(mpc, env, MPC_STEPS, seeds, record=MPC_CPU_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters()
    check("MPC on the 3D quad: K1 once a general-engine step",
          launches["k1"] == MPC_STEPS and sum(launches.values()) == MPC_STEPS,
          f"launches {launches} in {MPC_STEPS} steps at B={MPC_SOLVE_B}")
    goal = torch.tensor([0.3, -0.2, 1.0], device=dev)
    err = (xs[-1][:, [0, 2, 4]] - goal).norm(dim=-1).cpu()
    first = float((xs[0][:, [0, 2, 4]] - goal).norm(dim=-1).median())
    median = float(err.median())
    check(f"MPC on the 3D quad: the bar after {MPC_STEPS} steps",
          bool(torch.isfinite(err).all()) and median <= MPC_BAR_MEDIAN
          and median <= MPC_BAR_FALL * first,
          f"median position error {median:.4g} m (bar {MPC_BAR_MEDIAN}), {median / first:.3f} "
          f"of its {first:.4g} m after the first step (bar {MPC_BAR_FALL}), max "
          f"{float(err.max()):.4g} m")

    mpc_c = MPC(make_quadrotor(QuadrotorConfig(**MPC_QUAD3D), device="cpu"), **MPC_QUAD3D_KW)
    mpc_c.P_term = mpc.P_term.cpu()
    cpu_errs = check_solves("MPC on the 3D quad", mpc_c, solves, MPC_CPU_B, MPC3D_COST_RTOL,
                            MPC3D_US_REL)

    # K1 in the profiler: two general-engine steps of the loop (the solves
    # launch no K1: the counters above saw K1 exactly once a step).
    vec = make_vec_env(env, MPC_SOLVE_B, auto_reset=False)
    loop = dict(zip(("s", "o"), vec.reset(env_seeds=seeds)[:2]))
    act = torch.clamp(mpc.solve_batch(loop["o"], 0)[0][:, 0], mpc._u_lo, mpc._u_hi)

    def step():
        loop["s"], loop["o"], _, _, _ = vec.step_no_reset(loop["s"], act)

    _, kern = profile_kernels(step, 2)
    k1 = [(t, n) for k, (t, n) in kern.items() if "quad3d_substeps_kernel" in k]
    k1_n = sum(n for _, n in k1)
    check("a profile of two closed-loop env steps holds two K1 launches", k1_n == 2,
          f"K1 launches seen {k1_n}")
    res = {"launches": launches, "steps": MPC_STEPS, "host_ms_per_step": secs / MPC_STEPS * 1e3,
           "median_final_pos_err": median, "median_first_pos_err": first,
           "max_final_pos_err": float(err.max()), "cpu_cost_rel_err": cpu_errs[0],
           "cpu_us_rel_err": cpu_errs[1], "k1_ms_per_launch": sum(t for t, _ in k1) / k1_n,
           "env_step_launches": sum(n for _, n in kern.values()) / 2}
    print(f"  MPC, 3D quad (B={MPC_SOLVE_B}, H={MPC_H}, 2x3 iterations): "
          f"{res['host_ms_per_step']:.2f} host ms a closed-loop step ({MPC_STEPS} steps, K1 "
          f"{launches['k1']}); profiled env step: {res['env_step_launches']:.0f} kernel launches, "
          f"K1 {res['k1_ms_per_launch'] * 1e3:.4f} us a launch; {card_line()}", flush=True)
    return res


def phase_ilqr(dev):
    """iLQR on the CartPole config of tests/test_controllers.py:65-79:
    ``learn()`` on the card, its final cost against the CPU's (rtol
    ILQR_COST_RTOL), one episode of the learned policy on the card ending
    with |x|, |theta| < 0.1; the wall time of ``learn`` and of one backward
    pass, whose 200 steps each run an ``eigh`` that synchronizes with the
    host, and of 200 such ``eigh`` calls alone."""
    import torch

    from safe_control_gym_torch.controllers.ilqr import iLQR
    from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole
    from safe_control_gym_torch.parallel.vector import make_vec_env

    env = make_cartpole(CartPoleConfig(**ILQR_CARTPOLE), device=dev)
    il = iLQR(env, q_lqr=[1.0], r_lqr=[0.1], max_iterations=8)
    learn_ms, out = timed(il.learn, 1)
    il_c = iLQR(make_cartpole(CartPoleConfig(**ILQR_CARTPOLE), device="cpu"), q_lqr=[1.0],
                r_lqr=[0.1], max_iterations=8)
    cost_c = il_c.learn()["cost"]
    cost_err = abs(out["cost"] - cost_c) / abs(cost_c)
    check("iLQR learn() on the card against the CPU", cost_err < ILQR_COST_RTOL,
          f"final cost {out['cost']:.7g} (CPU {cost_c:.7g}, rel {cost_err:.3g}, rtol "
          f"{ILQR_COST_RTOL:g}) in {learn_ms:.1f} ms")
    vec = make_vec_env(env, 1, auto_reset=False)
    state, obs, _ = vec.reset(env_seeds=torch.tensor([0], dtype=torch.int32, device=dev))
    x_init = state.x[0]
    il.reset()
    for _ in range(env.max_episode_steps):
        a = il.select_action(obs[0].cpu().numpy())
        state, obs, _, done, _ = vec.step_no_reset(state, torch.as_tensor(a, device=dev)[None])
        if bool(done[0]):
            break
    x = state.x[0].cpu().numpy()
    check("iLQR episode on the card: |x|, |theta| < 0.1", float(np.abs(x[[0, 2]]).max()) < 0.1,
          f"final state {np.round(x, 5).tolist()}")
    xs, us = il._forward(x_init, il.gains_fb, il.input_ff)
    bwd_ms, _ = timed(lambda: il._backward(xs, us, 1.0), 3)
    H = torch.full((1, 1), 0.5, device=dev)
    eigh_ms, _ = timed(lambda: [torch.linalg.eigh(H) for _ in range(il.T)], 3)
    res = {"learn_ms": learn_ms, "cost": out["cost"], "cpu_cost": cost_c,
           "backward_ms": bwd_ms, "eigh_200_ms": eigh_ms, "final_state": x.tolist()}
    print(f"  iLQR, CartPole: learn() {learn_ms:.1f} ms; one backward pass ({il.T} steps) "
          f"{bwd_ms:.2f} ms, of which {il.T} eigh calls alone take {eigh_ms:.2f} ms; "
          f"{card_line()}", flush=True)
    return res


def phase_linear_mpc(dev):
    """LinearMPC on the config of tests/test_mpc.py:79-96 (2D quad to (0,
    1), horizon 20, 1 AL x 4 inner iterations, the LQR terminal cost),
    batched over LMPC_B envs for 150 steps on the general engine: every env
    ends with |x| < 0.05 and |z - 1| < 0.05."""
    import torch

    from safe_control_gym_torch.controllers.linear_mpc import LinearMPC
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.ops import ctr_prng

    env = make_quadrotor(QuadrotorConfig(**LMPC_QUAD2D), device=dev)
    lmpc = LinearMPC(env, horizon=MPC_H, q_mpc=[1.0], r_mpc=[0.1], al_iters=1, inner_iters=4,
                     terminal_lqr_cost=True)
    steps = 150
    ms, (xs, _) = timed(lambda: mpc_loop(lmpc, env, steps,
                                         ctr_prng.env_seeds_from_seed(0, LMPC_B, dev)), 1)
    x = xs[-1].cpu()
    worst = float(torch.maximum(x[:, 0].abs(), (x[:, 2] - 1.0).abs()).max())
    check(f"LinearMPC on the 2D quad, B={LMPC_B}: every env at |x|, |z - 1| < 0.05", worst < 0.05,
          f"largest final |x| or |z - 1| {worst:.4g}")
    res = {"host_ms_per_step": ms / steps, "worst_final_err": worst}
    print(f"  LinearMPC, 2D quad: {res['host_ms_per_step']:.2f} host ms a closed-loop step at "
          f"B={LMPC_B}; {card_line()}", flush=True)
    return res


def gp_cpu_copy(gp, gp_state=None):
    """GP-MPC ``gp``'s settings on a CPU env, with ``gp``'s GPs (or
    ``gp_state``), prior gain and terminal cost."""
    from safe_control_gym_torch.controllers.gp_mpc import GPMPC
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.ops.gp import GPParams, GPState

    gp_c = GPMPC(make_quadrotor(QuadrotorConfig(**GP_QUAD2D), device="cpu"), **GP_KW)
    s = gp.gp_state if gp_state is None else gp_state
    gp_c.gp_state = GPState(GPParams(*(t.cpu() for t in s.params)), *(t.cpu() for t in s[1:]))
    gp_c.K_prior, gp_c.P_term = gp.K_prior.cpu(), gp.P_term.cpu()
    gp_c._solve = gp_c._make_gp_solver()
    return gp_c


def gp_loop(gp, env, seed):
    """GP_STEPS closed-loop steps of GP_B envs from states drawn around
    hover from ``seed``, every solve recorded (``mpc_loop``)."""
    import torch

    rng = np.random.default_rng(seed)
    x0s = (rng.normal(size=(GP_B, 6)) * [0.1, 0.1, 0.1, 0.1, 0.05, 0.05]
           + [0, 0, 0.9, 0, 0, 0]).astype(np.float32)
    seeds = torch.arange(GP_B, dtype=torch.int32, device=env.device)
    return mpc_loop(gp, env, GP_STEPS, seeds, torch.as_tensor(x0s, device=env.device),
                    record=GP_STEPS)


def phase_gp_mpc(dev):
    """GP-MPC on the 2D quad whose mass is not the prior's
    (tests/test_gp_mpc.py:103-118) with the mixed constraint rows: ``learn()``
    on the card (150 exploration steps, 40 inducing points, 80 Adam steps),
    then ``probabilistic_margins`` (finite, the symmetric row untightened at
    x0 and growing along the horizon); then GP_STEPS closed-loop steps of
    GP_B envs from seeded states on the card, each solve redone on the CPU
    with the card's GPs, prior gain and terminal cost (``check_solves`` at
    GP_COST_RTOL, GP_US_REL)."""
    import torch

    from safe_control_gym_torch.controllers.gp_mpc import GPMPC
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor

    env = make_quadrotor(QuadrotorConfig(**GP_QUAD2D), device=dev)
    gp = GPMPC(env, **GP_KW)
    learn_ms, out = timed(gp.learn, 1)
    x0 = torch.tensor([0.0, 0.0, 0.9, 0.0, 0.0, 0.0], device=dev)
    m = gp.probabilistic_margins(x0, gp._u_eq2.expand(gp.T, -1) * 1.05).cpu()
    sym = m[:, 5]  # the first symmetric row (spec order: quadratic, 4 input rows)
    check("GP-MPC learn() and margins on the card",
          bool(torch.isfinite(m).all()) and float(sym[0]) == 0.0
          and bool((sym[1:] - sym[:-1] > -1e-9).all()) and float(sym[-1]) > float(sym[1]),
          f"{out['train_points']} training points in {learn_ms:.0f} ms; symmetric row margins "
          f"{np.round(sym.numpy(), 5).tolist()}")
    gp_c = gp_cpu_copy(gp)
    loop_ms, (xs, solves) = timed(lambda: gp_loop(gp, env, 0), 1)
    cpu_errs = check_solves("GP-MPC", gp_c, solves, GP_B, GP_COST_RTOL, GP_US_REL)
    res = {"learn_ms": learn_ms, "train_points": out["train_points"],
           "margins_sym_row": sym.tolist(), "host_ms_per_step": loop_ms / GP_STEPS,
           "cpu_cost_rel_err": cpu_errs[0], "cpu_us_rel_err": cpu_errs[1]}
    print(f"  GP-MPC, 2D quad: learn() {learn_ms:.0f} ms, {res['host_ms_per_step']:.2f} host ms "
          f"a closed-loop step at B={GP_B}; {card_line()}", flush=True)
    return res


def phase_cbf(dev):
    """The CBF-QP filter on CartPole (tests/test_rl.py:114-130, slope 0.5,
    soft): ``certify`` on CBF_B seeded states and desired inputs on the card
    against the CPU with the same residual MLP (inputs and slacks atol
    CBF_ATOL), its ms; ``is_cbf(num_points=10)`` on both, the same verdict
    and infeasible points."""
    import torch

    from safe_control_gym_torch.controllers.cbf import CBF_QP
    from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole

    cfg = dict(task="stabilization", cost="rl_reward", normalized_rl_action_space=False,
               randomized_init=True, episode_len_sec=5)
    cbf = CBF_QP(make_cartpole(CartPoleConfig(**cfg), device=dev), slope=0.5)
    cbf_c = CBF_QP(make_cartpole(CartPoleConfig(**cfg), device="cpu"), slope=0.5)
    cbf_c.mlp.load_state_dict({k: v.cpu() for k, v in cbf.mlp.state_dict().items()})
    rng = np.random.default_rng(0)
    X = torch.as_tensor((rng.normal(size=(CBF_B, 4)) * [1.5, 1.0, 0.2, 0.5]).astype(np.float32))
    Ud = torch.as_tensor((rng.normal(size=(CBF_B, 1)) * 5).astype(np.float32))
    with torch.no_grad():
        cert_ms, (u, s) = timed(lambda: cbf.certify(X.to(dev), Ud.to(dev)), 3)
        u_c, s_c = cbf_c.certify(X, Ud)
    err = max(max_err(u.cpu(), u_c), max_err(s.cpu(), s_c))
    check(f"CBF certify on the card against the CPU (B={CBF_B})", err < CBF_ATOL,
          f"inputs and slacks max_abs_err {err:.3g} (atol {CBF_ATOL:g}); "
          f"{int((s_c > cbf.slack_tolerance).sum())} envs need slack")
    (ok, bad), (ok_c, bad_c) = cbf.is_cbf(num_points=10), cbf_c.is_cbf(num_points=10)
    check("CBF is_cbf(num_points=10) on the card against the CPU",
          ok == ok_c and np.array_equal(bad, bad_c), f"verdict {ok} (CPU {ok_c}), "
          f"{len(bad)} infeasible points (CPU {len(bad_c)})")
    res = {"certify_ms": cert_ms, "max_abs_err": err, "is_cbf": ok}
    print(f"  CBF certify: {cert_ms:.2f} ms for {CBF_B} states (200 ADMM iterations); "
          f"{card_line()}", flush=True)
    return res


# -- The firmware and the competition stack ----------------------------------

FW_STEPS = 60  # tests/test_firmware.py:175-202's script: takeoff, a goto at step 25
FW_GOTO_STEP = 25
FW_ATOL = 2e-2  # the JAX suite's fused-against-host tolerance (obs and actions)
FW_TIMED_BLOCKS = 10  # fused blocks timed after the script
COMP_FW_FREQ, COMP_CTRL_FREQ = 500, 25
# The level-2 default-stack flight, cut from 33 s: takeoff and the first
# MPCC solves, cold and warm.  A 6-s flight took 336 s on a slow host.  The
# MPCC stage starts at control step 51, and its first 8 solves are cold
# (``warm_after``): 2.5 s (62 steps) gives 8 cold and 3 warm solves.
COMP_EPISODE_S = 2.5
COMP_SIM_FREQ = 60  # the sim-only path's control rate (tests/test_competition.py:121)
K1_B1_SAMPLES = 64  # K1 inputs of the competition flight held against the plain version
K1_B1_STRIDE = 40  # one K1 input kept every K1_B1_STRIDE ticks of the flight
K1_B1_REPS = 400  # profiled K1 launches at B = 1
# Calls of K1's plain version timed (CUDA events) beside the kernel at B = 1
# and 4 and at the fit's B = 4096: 7-10 ms each, host-bound.
K1_PLAIN_REPS = 40
LEVELS_DIR = os.path.join(ROOT, "safe_control_gym_tpu", "competition", "levels")
EMPTY_KERNEL_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void smoke_empty_kernel() {}
extern "C" int smoke_empty(int grid, int block, void* stream) {
  smoke_empty_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def load_level(n, **overrides):
    """A competition level's config, read from the JAX package's YAML file
    (data only: nothing of that package is imported)."""
    import yaml

    with open(os.path.join(LEVELS_DIR, f"level{n}.yaml")) as f:
        level = yaml.safe_load(f)["quadrotor_config"]
    level.update(overrides)
    return level


def firmware_env(dev, **kw):
    """tests/test_firmware.py:16-30's env: hover takeoff from the ground at
    500 Hz, no out-of-bound done."""
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor

    cfg = dict(quad_type=3, task="stabilization", cost="rl_reward",
               task_info={"stabilization_goal": [0, 0, 1], "stabilization_goal_tolerance": 0.05},
               randomized_init=False, init_state={"init_z": 0.03}, episode_len_sec=6,
               ctrl_freq=COMP_FW_FREQ, pyb_freq=COMP_FW_FREQ, done_on_out_of_bound=False)
    cfg.update(kw)
    return make_quadrotor(QuadrotorConfig(**cfg), device=dev)


def phase_firmware(dev):
    """The firmware emulator (``controllers/firmware.py``) on the card: the
    fused block against the host loop over tests/test_firmware.py:175-202's
    script (takeoff, a goto at control step 25, 60 control steps at 25 Hz;
    obs and actions within FW_ATOL, done and tick equal), with the launch
    counters zeroed just before each of the fused wrapper's steps and read
    just after (K1 once a tick, nothing else: 20 a control step, the float
    tick test giving a step 19 or 21 ticks now and then); one fused block's
    device part under ``set_sync_debug_mode("error")`` (its pinned input
    copy included); the device operations one block launches (profiler)
    and host ms a block."""
    import torch

    from safe_control_gym_torch.controllers.firmware import FirmwareWrapper

    fwf = FirmwareWrapper(firmware_env(dev), COMP_FW_FREQ, COMP_CTRL_FREQ, fused=True)
    fwh = FirmwareWrapper(firmware_env(dev), COMP_FW_FREQ, COMP_CTRL_FREQ, fused=False)
    for fw in (fwf, fwh):
        fw.reset(seed=3)
        fw.sendTakeoffCmd(1.0, 2.0)
    af = ah = np.zeros(4)
    err, exact, fused_s, k1 = 0.0, True, 0.0, 0
    for i in range(FW_STEPS):
        if i == FW_GOTO_STEP:
            for fw in (fwf, fwh):
                fw.sendGotoCmd([0.4, -0.2, 1.1], 0.0, 1.5, relative=False)
        zero_counters()
        tick0, t0 = fwf.tick, time.perf_counter()
        of, rf, df, inf_f, af = fwf.step(i / COMP_CTRL_FREQ, af)
        fused_s += time.perf_counter() - t0
        launches = read_counters()
        k1 += launches["k1"]
        if launches["k1"] != fwf.tick - tick0 or sum(launches.values()) != launches["k1"]:
            check(f"firmware: K1 once a tick in control step {i}", False,
                  f"launches {launches}, ticks {fwf.tick - tick0}")
        oh, rh, dh, inf_h, ah = fwh.step(i / COMP_CTRL_FREQ, ah)
        e = max(float(np.abs(of - oh).max()), float(np.abs(np.asarray(af) - ah).max()))
        err = max(err, e)
        exact = exact and np.array_equal(of, oh) and np.array_equal(af, ah)
        if not (e <= FW_ATOL and df == dh and fwf.tick == fwh.tick):
            check(f"firmware: fused block against the host loop, control step {i}", False,
                  f"max_abs_err {e:.3g}, done {df}/{dh}, tick {fwf.tick}/{fwh.tick}")
    pos = np.array([of[0], of[2], of[4]])
    goal_err = float(np.linalg.norm(pos - np.array([0.4, -0.2, 1.1])))
    check("firmware: fused block against the host loop", err <= FW_ATOL and goal_err < 0.15
          and k1 == fwf.tick == 20 * FW_STEPS,
          f"{FW_STEPS} control steps, max_abs_err {err:.3g} (atol {FW_ATOL:g}; bit for bit: "
          f"{exact}), ticks {fwf.tick}, final distance to the goto target {goal_err:.4f} m; "
          f"K1 {k1} launches ({k1 / FW_STEPS:g} a control step)")

    # One block's device part under the sync debug mode: the pinned input
    # copy and the ticks.
    a = af
    step = {"i": FW_STEPS}

    def block(debug):
        t = step["i"] / COMP_CTRL_FREQ
        ticks, run_ctrl, gate_after, sp_seq, plan_active = fwf._plan_block(t)
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fwf._launch_block(*fwf._block_inputs(run_ctrl, sp_seq, a))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        step["i"] += 1
        return fwf._read_block(out, gate_after, sp_seq, plan_active)

    obs, _, done, _, _ = block(debug=True)
    check("firmware: a fused block without a host sync", bool(np.isfinite(obs).all()) and not done,
          "one control step (the pinned input copy and 20 ticks) under "
          "set_sync_debug_mode('error')")
    t0 = time.perf_counter()
    for _ in range(FW_TIMED_BLOCKS):
        block(debug=False)
    block_ms = (time.perf_counter() - t0) / FW_TIMED_BLOCKS * 1e3
    t = step["i"] / COMP_CTRL_FREQ
    ticks, run_ctrl, gate_after, sp_seq, plan_active = fwf._plan_block(t)
    inputs = fwf._block_inputs(run_ctrl, sp_seq, a)
    holder = {}
    launches, busy, top = profile_launches(lambda: holder.setdefault("out", fwf._launch_block(
        *inputs)))
    fwf._read_block(holder["out"], gate_after, sp_seq, plan_active)
    res = {"steps": FW_STEPS, "max_abs_err": err, "bit_equal": bool(exact),
           "goal_err_m": goal_err, "fused_ms_per_step": fused_s / FW_STEPS * 1e3,
           "block_ms": block_ms, "launches_per_block": launches, "device_ms_per_block": busy,
           "ticks_per_block": len(ticks), "k1_per_step": k1 / FW_STEPS, "top": top}
    print(f"  firmware (tests/test_firmware.py's env, 25 Hz over 500 Hz): {block_ms:.2f} host ms "
          f"a fused block of {len(ticks)} ticks ({res['fused_ms_per_step']:.2f} over the script); "
          f"{launches} device operations a block, device busy {busy:.3f} ms; fused/host "
          f"max_abs_err {err:.3g}; {card_line()}", flush=True)
    return res


def phase_competition_sim_only(dev):
    """``getting_started.run`` on level 0 with ``use_firmware=False`` and
    ``ctrl_freq=60`` (the software PID path, K1 once a control step), the
    whole episode, the launch counters zeroed just before and read just
    after; the bar of tests/test_competition.py:116-125: 4 gates, 0
    collisions, reward > 300."""
    from safe_control_gym_torch.competition.getting_started import run

    zero_counters()
    t0 = time.perf_counter()
    ep = run(load_level(0), num_episodes=1, use_firmware=False, ctrl_freq=COMP_SIM_FREQ,
             device=dev)[0]
    wall = time.perf_counter() - t0
    launches = read_counters()
    check("competition level 0, sim-only: the bar",
          ep["gates_passed"] == 4 and ep["collisions"] == 0 and ep["reward"] > 300,
          f"{ep}")
    check("competition level 0, sim-only: K1 once a control step",
          launches["k1"] == ep["steps"] and sum(launches.values()) == ep["steps"],
          f"launches {launches} in {ep['steps']} steps")
    res = {**ep, "wall_s": wall, "launches": launches}
    print(f"  level 0 sim-only (PID, {COMP_SIM_FREQ} Hz): {ep['steps']} steps, "
          f"{ep['steps_per_sec']:.4g} steps/s (planning included), sim_speedup "
          f"{ep['sim_speedup']:.4g}, reward {ep['reward']}; {card_line()}", flush=True)
    return res


_EMPTY_LIB = {}


def empty_kernel_ms(dev, grid, block, reps):
    """The profiler's mean device time of an empty kernel at ``grid`` x
    ``block``: the floor of one launch."""
    import ctypes

    from safe_control_gym_torch import kernels

    lib = _EMPTY_LIB.get("lib")
    if lib is None:  # built once a process
        out_dir = kernels.BUILD / "smoke"
        out_dir.mkdir(parents=True, exist_ok=True)
        src, so = out_dir / "smoke_empty.cu", out_dir / "libsmoke_empty.so"
        src.write_text(EMPTY_KERNEL_SOURCE)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(src), "-o", str(so)],
                       check=True, capture_output=True)
        lib = _EMPTY_LIB["lib"] = ctypes.CDLL(str(so))
        lib.smoke_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.smoke_empty.restype = ctypes.c_int
    stream = kernels.stream_ptr(dev)
    return kernel_device_ms(lambda: kernels.check(lib.smoke_empty(grid, block, stream),
                                                  "smoke_empty"), "smoke_empty_kernel", reps)


class FlightProbe:
    """Times and counts the default competition stack during one ``run``:
    each fused control step (host ms, ticks executed), each MPCC solve (host
    ms, its iteration counts), the wrapper and the MPCC controllers seen,
    and every K1_B1_STRIDE-th K1 input of the flight (cloned on the device).
    Restores what it wrapped on exit."""

    def __init__(self, stride):
        self.blocks, self.solves, self.k1_inputs = [], [], []
        self.wrapper, self.mpccs, self.stride, self.calls = None, [], stride, 0

    def __enter__(self):
        from safe_control_gym_torch.competition import mpcc_controller as M
        from safe_control_gym_torch.controllers import firmware as FWm
        from safe_control_gym_torch.envs import quadrotor as Q

        probe = self
        self._saved = [(FWm.FirmwareWrapper, "_step_fused", FWm.FirmwareWrapper._step_fused),
                       (M.MPCCController, "solve", M.MPCCController.solve),
                       (Q, "quad3d_substeps", Q.quad3d_substeps)]
        step_fused, solve, k1 = (s[2] for s in self._saved)

        def timed_step(self_, sim_time, action):
            probe.wrapper = self_
            tick0, t0 = self_.tick, time.perf_counter()
            out = step_fused(self_, sim_time, action)
            probe.blocks.append(((time.perf_counter() - t0) * 1e3, self_.tick - tick0))
            return out

        def timed_solve(self_, *a, **k):
            if self_ not in probe.mpccs:
                probe.mpccs.append(self_)
            t0 = time.perf_counter()
            out = solve(self_, *a, **k)
            probe.solves.append(((time.perf_counter() - t0) * 1e3, self_.last_iters))
            return out

        def recording_k1(*a, **k):
            if probe.calls % probe.stride == 0 and len(probe.k1_inputs) < K1_B1_SAMPLES:
                probe.k1_inputs.append((tuple(t.clone() for t in a), dict(k)))
            probe.calls += 1
            return k1(*a, **k)

        FWm.FirmwareWrapper._step_fused = timed_step
        M.MPCCController.solve = timed_solve
        Q.quad3d_substeps = recording_k1
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)
        return False


def phase_competition(dev):
    """``getting_started.run`` with the default stack (the fused 500 Hz
    firmware block, the MPCC racing stage) on level 2, seed 2, the episode
    cut to COMP_EPISODE_S (the only reduction; one drone is the
    competition's size), the launch counters zeroed just before and read
    just after: the bar (no collision, no early done), K1 launches equal to
    the ticks executed; ms a fused block, ms an MPCC solve cold and warm,
    the device operations of a cold and a warm solve (profiler).  K1 at B =
    1: the flight's own K1 inputs (one every K1_B1_STRIDE ticks) against the plain
    version bit for bit, K1's device ms a launch at B = 1 and an empty
    kernel's at the same grid and block (the launch floor), and the plain
    version's ms a call (CUDA events, host launches included)."""
    import torch

    from safe_control_gym_torch.competition.getting_started import run
    from safe_control_gym_torch.ops import quad_substeps as K1

    level = load_level(2, seed=2, episode_len_sec=COMP_EPISODE_S)
    steps = int(COMP_EPISODE_S * COMP_CTRL_FREQ)
    zero_counters()
    t0 = time.perf_counter()
    with FlightProbe(stride=K1_B1_STRIDE) as probe:
        ep = run(level, num_episodes=1, device=dev)[0]
    wall = time.perf_counter() - t0
    launches = read_counters()
    ticks = probe.wrapper.tick
    check("competition level 2, default stack: no collision, no early done",
          ep["steps"] == steps and ep["collisions"] == 0, f"{ep}")
    check("competition level 2, default stack: K1 once a firmware tick",
          launches["k1"] == ticks and sum(launches.values()) == ticks,
          f"launches {launches}, ticks executed {ticks} in {ep['steps']} control steps")
    block_ms = [ms for ms, _ in probe.blocks]
    cold = [ms for ms, it in probe.solves if it == (2, 6)]
    warm = [ms for ms, it in probe.solves if it == (1, 3)]
    check("competition level 2: MPCC solves, cold and warm", len(cold) >= 1 and len(warm) >= 1
          and len(cold) + len(warm) == len(probe.solves),
          f"{len(cold)} cold, {len(warm)} warm of {len(probe.solves)}")

    # Launches of one cold and one warm solve, from the flight's last state.
    mpcc = probe.mpccs[-1]
    obs = np.array(probe.wrapper.env_state.x[0].cpu().numpy(), np.float64)
    theta = float(mpcc.theta_grid[len(mpcc.theta_grid) // 3])
    saved = (mpcc._us_prev, mpcc._mu_prev, mpcc._n_solves, mpcc._last_frames)
    counts = {}
    for tag in ("cold", "warm"):
        if tag == "cold":
            mpcc.reset()
        else:
            mpcc._n_solves = mpcc.warm_after
        n, busy, top = profile_launches(lambda: mpcc.solve(obs, theta, 1.0))
        counts[tag] = {"launches": n, "device_ms": busy, "iters": mpcc.last_iters, "top": top}
    mpcc._us_prev, mpcc._mu_prev, mpcc._n_solves, mpcc._last_frames = saved

    # K1 at B = 1 on the flight's own inputs.
    same, err = True, 0.0
    for args, kw in probe.k1_inputs:
        out = K1.quad3d_substeps(*args, **kw)
        ref = K1.quad3d_substeps_plain(*args, **kw)
        err = max(err, max_err(out, ref))
        same = same and torch.equal(out, ref)
    plan = K1.launch_plan(1, torch.float32)
    check(f"K1 at B=1 (G={plan[0]}) vs plain on the competition flight's inputs",
          same and len(probe.k1_inputs) == min(K1_B1_SAMPLES, -(-ticks // K1_B1_STRIDE)),
          f"{len(probe.k1_inputs)} inputs, max_abs_err {err:.3g} (bit-equal expected)")
    args, kw = probe.k1_inputs[len(probe.k1_inputs) // 2]
    k1_ms = kernel_device_ms(lambda: K1.quad3d_substeps(*args, **kw), "quad3d_substeps_kernel",
                             K1_B1_REPS)
    floor_ms = empty_kernel_ms(dev, plan[2], plan[1], K1_B1_REPS)
    plain_ms = cuda_ms(lambda: K1.quad3d_substeps_plain(*args, **kw), K1_PLAIN_REPS)
    res = {**ep, "wall_s": wall, "launches": launches, "ticks": ticks,
           "blocks": len(block_ms), "block_ms": float(np.mean(block_ms)),
           "block_ms_median": float(np.median(block_ms)),
           "solves": len(probe.solves), "cold_solves": len(cold), "warm_solves": len(warm),
           "cold_solve_ms": float(np.mean(cold)), "warm_solve_ms": float(np.mean(warm)),
           "solve_launches": counts, "blocks_s": sum(block_ms) / 1e3,
           "solves_s": sum(ms for ms, _ in probe.solves) / 1e3,
           "k1_b1": {"plan": plan, "max_abs_err": err, "samples": len(probe.k1_inputs),
                     "ms": k1_ms, "empty_kernel_ms": floor_ms, "plain_ms": plain_ms,
                     "launches": launches["k1"]}}
    print(f"  level 2 seed 2, default stack, {COMP_EPISODE_S:g} s: {ep['steps']} control steps, "
          f"{ep['steps_per_sec']:.4g} steps/s, sim_speedup {ep['sim_speedup']:.4g}, gates "
          f"{ep['gates_passed']}, reward {ep['reward']}; fused block {res['block_ms']:.2f} ms "
          f"(median {res['block_ms_median']:.2f}, {len(block_ms)} blocks, {res['blocks_s']:.1f} s); "
          f"MPCC {len(cold)} cold {res['cold_solve_ms']:.1f} ms, {len(warm)} warm "
          f"{res['warm_solve_ms']:.1f} ms ({res['solves_s']:.1f} s); launches a solve cold "
          f"{counts['cold']['launches']}, warm {counts['warm']['launches']}; K1 at B=1 "
          f"{k1_ms * 1e3:.4f} us a launch (empty kernel {floor_ms * 1e3:.4f} us, plain "
          f"{plain_ms:.4f} ms a call), "
          f"{launches['k1']} launches = {ticks} ticks; {card_line()}", flush=True)
    return res


# The learners (``phase_learners``) at the registry's widths
# (_registry_entries.py:47-66 of the JAX package): SAC and DDPG hidden 256,
# B = 4, train_interval 100, batch 64, a buffer of 1e6; the warm-up cut from
# 1000 (SAC) and 10000 (DDPG) env steps to 200, so that the last two of the
# LEARNER_STEPS timed train steps act from the policy.  RARL and RAP hidden
# 64, B = 4, T = 100; SafeExplorerPPO with PPO's defaults (hidden 64, B = 4,
# T = 100, 10 epochs of 6 minibatches of 64: K4 at mb = 64).
OFFPOLICY_KW = dict(hidden_dim=256, rollout_batch_size=4, train_interval=100,
                    train_batch_size=64, max_buffer_size=1_000_000, warm_up_steps=200)
RARL_KW = dict(hidden_dim=64, rollout_batch_size=4, rollout_steps=100)
LEARNER_STEPS = 4
# tests/test_rl.py::test_sac_runs_and_improves on CartPole: its settings and
# its bar (r1 > r0, finite losses), on the card.
LEARN_GATE_KW = dict(rollout_batch_size=4, train_interval=100, warm_up_steps=400,
                     train_batch_size=256, max_buffer_size=20000, updates_per_step=10,
                     use_entropy_tuning=True)
LEARN_GATE_STEPS = 80
K1_SMALL_REPS = 400  # profiled K1 launches at B = 4 and at the fit's B = 4096
K4_MB64_REPS = 200  # profiled K4 calls at mb = 64
# tests/test_sim2real.py:63-97's synthetic flight and bars (``phase_sim2real``).
FIT_MASS, FIT_KF, FIT_DT, FIT_T = 0.031, 1.12, 1 / 60, 120
FIT_CANDIDATES = 4096
FIT_K1_STRIDE = 10  # one K1 input of the fit kept every FIT_K1_STRIDE steps


class K1Recorder:
    """Keeps every ``stride``-th input of the K1 calls a module makes
    (its global ``quad3d_substeps``), cloned; restores it on exit."""

    def __init__(self, module, stride=1, most=64):
        self.module, self.stride, self.most = module, stride, most
        self.inputs, self.calls = [], 0

    def __enter__(self):
        self.saved = k1 = self.module.quad3d_substeps

        def recording(*a, **k):
            if self.calls % self.stride == 0 and len(self.inputs) < self.most:
                self.inputs.append((tuple(t.clone() for t in a), dict(k)))
            self.calls += 1
            return k1(*a, **k)

        self.module.quad3d_substeps = recording
        return self

    def __exit__(self, *exc):
        self.module.quad3d_substeps = self.saved
        return False


def k1_small(tag, dev, inputs, reps=K1_SMALL_REPS):
    """K1 on a path's own inputs against its plain version bit for bit, its
    profiled device ms a launch, an empty kernel's at the same grid and
    block (the launch floor), and the plain version's ms a call."""
    import torch

    from safe_control_gym_torch.ops import quad_substeps as K1

    same, err = True, 0.0
    for args, kw in inputs:
        out, ref = K1.quad3d_substeps(*args, **kw), K1.quad3d_substeps_plain(*args, **kw)
        err = max(err, max_err(out, ref))
        same = same and torch.equal(out, ref)
    args, kw = inputs[len(inputs) // 2]
    B = args[0].shape[0]
    plan = K1.launch_plan(B, args[0].dtype)
    check(f"K1 at B={B} (G={plan[0]}, actuation {kw['actuation']}) vs plain on {tag}'s inputs",
          same and len(inputs) > 0, f"{len(inputs)} inputs, max_abs_err {err:.3g} (bit-equal "
          "expected)")
    return {"batch": B, "plan": plan, "samples": len(inputs), "max_abs_err": err,
            "n_sub": kw["n_sub"], "actuation": kw["actuation"],
            "ms": kernel_device_ms(lambda: K1.quad3d_substeps(*args, **kw),
                                   "quad3d_substeps_kernel", reps),
            "empty_kernel_ms": empty_kernel_ms(dev, plan[2], plan[1], reps),
            "plain_ms": cuda_ms(lambda: K1.quad3d_substeps_plain(*args, **kw), K1_PLAIN_REPS)}


def timed_steps(agent, steps):
    """``steps`` train steps, each synchronized, with the launch counters
    zeroed just before and read just after: (host ms of each, launches,
    the last metrics)."""
    import torch

    zero_counters()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        agent.state, m = agent._train_step(agent.state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, read_counters(), m


def sync_free_step(tag, agent):
    """One train step under ``set_sync_debug_mode("error")``: any host-device
    synchronization raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        agent.state, m = agent._train_step(agent.state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(f"{tag}: a train step without a host sync", True,
          "under set_sync_debug_mode('error')")
    return m


def offpolicy_path(dev, cls, tag, **extra):
    """SAC or DDPG on config 4: a warm-up train step, LEARNER_STEPS timed
    ones (K1 once an env step, 25 a train step, and nothing else), one under
    the sync debug mode, one profiled (device operations and busy ms), and
    K1 at B = 4 on the path's own inputs."""
    import torch

    from safe_control_gym_torch.envs import quadrotor as Q
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    agent = cls(make_quadrotor(cfg4(), device=dev), seed=0, **OFFPOLICY_KW, **extra)
    env_steps = agent.cfg.train_interval // agent.cfg.rollout_batch_size
    agent.state, _ = agent._train_step(agent.state)
    torch.cuda.synchronize()
    ms, launches, m = timed_steps(agent, LEARNER_STEPS)
    losses = {k: float(v) for k, v in m.items()}
    check(f"{tag} on config 4: K1 once an env step",
          launches["k1"] == env_steps * LEARNER_STEPS and sum(launches.values()) == launches["k1"],
          f"launches {launches} in {LEARNER_STEPS} train steps of {env_steps} env steps")
    check(f"{tag} on config 4: finite losses, the policy acting",
          all(np.isfinite(v) for v in losses.values())
          and agent.state.total_steps > agent.cfg.warm_up_steps, f"{losses}, "
          f"{agent.state.total_steps} env steps (warm-up {agent.cfg.warm_up_steps})")
    sync_free_step(f"{tag} on config 4", agent)
    n_ops, busy, top = profile_launches(lambda: agent._train_step(agent.state))
    with K1Recorder(Q) as rec:
        agent.state, _ = agent._train_step(agent.state)
    torch.cuda.synchronize()
    res = {"train_steps": LEARNER_STEPS, "env_steps_per_train_step": env_steps,
           "host_ms": ms, "host_ms_per_train_step": float(np.mean(ms)), "launches": launches,
           "device_ops_per_train_step": n_ops, "device_ms_per_train_step": busy,
           "busy_share": busy / float(np.mean(ms)), "top": top, "metrics": losses,
           "k1": k1_small(tag, dev, rec.inputs)}
    print(f"  {tag}, config 4 (B=4, H=256, train_interval 100, batch 64): "
          f"{res['host_ms_per_train_step']:.2f} host ms a train step "
          f"({', '.join(f'{x:.1f}' for x in ms)}), "
          f"{n_ops} device operations and {busy:.3f} device ms a train step (busy "
          f"{res['busy_share']:.1%}); K1 {launches['k1']} launches; K1 at B=4 "
          f"{res['k1']['ms'] * 1e3:.4f} us (empty kernel {res['k1']['empty_kernel_ms'] * 1e3:.4f} "
          f"us); top {top}; {card_line()}", flush=True)
    return res


def rarl_path(dev, cls, tag, **extra):
    """A RARL or RAP cycle on config 4 with the adversary on the dynamics
    channel: a warm-up cycle, then one timed (K1 once an env step, 200 a
    cycle)."""
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    agent = cls(make_quadrotor(cfg4(adversary_disturbance="dynamics"), device=dev), seed=0,
                **RARL_KW, **extra)
    cfg = agent.cfg
    steps = (cfg.num_pro_iters + cfg.num_adv_iters) * cfg.rollout_steps
    agent.state, _ = agent._train_step(agent.state)
    torch.cuda.synchronize()
    ms, launches, m = timed_steps(agent, 1)
    check(f"{tag} on config 4 (adversary on the dynamics): K1 once an env step",
          launches["k1"] == steps and sum(launches.values()) == steps
          and np.isfinite(float(m["kl"])), f"launches {launches} in a cycle of {steps} env "
          f"steps; kl {float(m['kl']):.4g}")
    print(f"  {tag}, config 4 (B=4, T=100, H=64{', 3 adversaries' if extra else ''}): "
          f"{ms[0]:.1f} host ms a cycle, K1 {launches['k1']} launches; {card_line()}", flush=True)
    return {"host_ms_per_cycle": ms[0], "launches": launches, "env_steps": steps,
            "kl": float(m["kl"])}


def safe_explorer_path(dev):
    """SafeExplorerPPO on config 4 (its box constraints): ``pretrain()``
    timed, then one train step with the counters zeroed just before and read
    just after (K1 once an env step; K4 opt_epochs x n_mini times), its K4
    minibatches held against the plain version, K4's device time a call at
    mb = 64 and the launch floor."""
    import torch

    from safe_control_gym_torch.controllers.safe_explorer import SafeExplorerPPO
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_update as U

    agent = SafeExplorerPPO(make_quadrotor(cfg4(), device=dev), seed=0)
    cfg, fu = agent.cfg, agent._fu
    check("SafeExplorerPPO on config 4: K4 takes the update", fu is not None,
          f"(obs {agent.obs_dim}, act {agent.act_dim}, H {cfg.hidden_dim}, mb "
          f"{cfg.mini_batch_size})")
    t0 = time.perf_counter()
    pre = agent.pretrain()
    torch.cuda.synchronize()
    pretrain_ms = (time.perf_counter() - t0) * 1e3
    n_mini = cfg.rollout_batch_size * cfg.rollout_steps // cfg.mini_batch_size
    recorded, grads = [], fu.grads

    def recording(mb, w):
        recorded.append((mb.clone(), {k: v.clone() for k, v in w.items()}))
        return grads(mb, w)

    fu.grads = recording
    try:
        ms, launches, m = timed_steps(agent, 1)
    finally:
        del fu.grads
    metrics = {k: float(v) for k, v in m.items()}
    check("SafeExplorerPPO on config 4: K1 once an env step, K4 once a minibatch",
          launches["k1"] == cfg.rollout_steps and launches["k4"] == cfg.opt_epochs * n_mini
          and sum(launches.values()) == launches["k1"] + launches["k4"]
          and np.isfinite(pre["pretrain_loss"]) and all(np.isfinite(v) for v in metrics.values()),
          f"launches {launches} ({cfg.opt_epochs} epochs x {n_mini} minibatches); pretrain loss "
          f"{pre['pretrain_loss']:.4g}; {metrics}")
    err = 0.0
    for mb, w in (recorded[0], recorded[-1]):  # the train step's first and last minibatch
        g, s = U.ppo_grads(mb, w, clip=fu.clip, act=fu.act)
        gp, sp = U.ppo_grads_plain(mb, w, clip=fu.clip, act=fu.act)
        err = max(err, check_grads(f"mb=64 (SafeExplorerPPO) vs plain", g, s, gp, sp))
    mb, w = recorded[0]
    _, kern = profile_kernels(lambda: U.ppo_grads(mb, w, clip=fu.clip, act=fu.act), K4_MB64_REPS)
    k4_ms = sum(t for k, (t, _) in kern.items() if "ppo_" in k) / K4_MB64_REPS
    plan = U._plans[(agent.obs_dim, agent.act_dim, cfg.hidden_dim, cfg.mini_batch_size,
                     mb.device.index)]
    per_call = 2 if plan[5] else 3  # the weights' pack kernel, the gradients, the reduction
    floor_ms = per_call * empty_kernel_ms(dev, plan[1] * 2 * plan[2], 256, K4_MB64_REPS)
    plain_ms = cuda_ms(lambda: U.ppo_grads_plain(mb, w, clip=fu.clip, act=fu.act), K4_MB64_REPS)
    res = {"pretrain_ms": pretrain_ms, "pretrain_loss": pre["pretrain_loss"],
           "host_ms_per_train_step": ms[0], "launches": launches, "metrics": metrics,
           "k4": {"mb": cfg.mini_batch_size, "launches": launches["k4"], "max_abs_err": err,
                  "ms": k4_ms, "kernels_per_call": per_call, "empty_kernel_ms": floor_ms,
                  "plain_ms": plain_ms, "plan": list(plan)}}
    print(f"  SafeExplorerPPO, config 4: pretrain {pretrain_ms:.1f} host ms (loss "
          f"{pre['pretrain_loss']:.4g}), a train step {ms[0]:.1f} host ms, K1 {launches['k1']}, "
          f"K4 {launches['k4']} launches; K4 at mb=64 {k4_ms * 1e3:.3f} us a call ({per_call} "
          f"kernels; {per_call} empty kernels {floor_ms * 1e3:.3f} us), plain {plain_ms:.4f} ms; "
          f"{card_line()}", flush=True)
    return res


def learning_gate(dev):
    """tests/test_rl.py::test_sac_runs_and_improves on the card: SAC on
    CartPole stabilization (5 s episodes) at the test's settings, 80 train
    steps of 10 updates; the bar r1 > r0 over 8 evaluation episodes (seed
    1), finite losses."""
    from safe_control_gym_torch.controllers.sac import SAC
    from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole

    env = make_cartpole(CartPoleConfig(task="stabilization", cost="rl_reward",
                                       normalized_rl_action_space=True, randomized_init=True,
                                       episode_len_sec=5), device=dev)
    sac = SAC(env, seed=0, **LEARN_GATE_KW)
    t0 = time.perf_counter()
    r0 = float(sac.run(num_episodes=8, seed=1)["ep_returns"].mean())
    for _ in range(LEARN_GATE_STEPS):
        sac.state, m = sac._train_step(sac.state)
    r1 = float(sac.run(num_episodes=8, seed=1)["ep_returns"].mean())
    wall = time.perf_counter() - t0
    losses = {k: float(v) for k, v in m.items()}
    check("SAC learns CartPole (tests/test_rl.py's bar: r1 > r0, finite losses)",
          r1 > r0 and np.isfinite(losses["critic_loss"]) and np.isfinite(losses["actor_loss"]),
          f"r0 {r0:.4g} -> r1 {r1:.4g} after {LEARN_GATE_STEPS} train steps; {losses}; "
          f"{wall:.1f} s")
    return {"r0": r0, "r1": r1, "metrics": losses, "wall_s": wall}


def phase_learners(dev):
    """The other learners on the card (``controllers/sac.py``, ``ddpg.py``,
    ``rarl.py``, ``safe_explorer.py``): SAC and DDPG on config 4 through
    the general engine (K1 once an env step, a train step sync-free), a
    RARL and a RAP cycle, SafeExplorerPPO's pretrain and train step (K4
    once a minibatch, mb = 64), and SAC's learning gate on CartPole."""
    from safe_control_gym_torch.controllers.ddpg import DDPG
    from safe_control_gym_torch.controllers.rarl import RAP, RARL
    from safe_control_gym_torch.controllers.sac import SAC

    return {"sac": offpolicy_path(dev, SAC, "SAC"),
            "ddpg": offpolicy_path(dev, DDPG, "DDPG"),
            "rarl": rarl_path(dev, RARL, "RARL"),
            "rap": rarl_path(dev, RAP, "RAP", num_adversaries=3),
            "safe_explorer": safe_explorer_path(dev),
            "learning_gate": learning_gate(dev)}


def synthetic_flight():
    """tests/test_sim2real.py:63-97's flight (mass 0.031, kf 1.12, dt 1/60,
    T = 120, 20% thrust noise from a seed), integrated by K1's plain version
    on the CPU: (positions (T, 3), per-motor forces (T, 4), x0 (12,))."""
    import torch

    from safe_control_gym_torch.envs.quadrotor import J_DIAG
    from safe_control_gym_torch.ops.quad_substeps import GRAVITY, quad3d_substeps_plain

    g = torch.Generator().manual_seed(0)
    hover = FIT_MASS * GRAVITY / 4 / FIT_KF
    acts = hover * (1 + 0.2 * torch.randn(FIT_T, 4, generator=g))
    x = torch.zeros(1, 12)
    x[0, 4] = 1.0
    x0, pos = x[0].clone(), []
    ext, mass, j = torch.zeros(1, 3), torch.tensor([FIT_MASS]), torch.tensor([J_DIAG])
    for t in range(FIT_T):
        x = quad3d_substeps_plain(x, acts[t:t + 1] * FIT_KF, ext, mass, j, dt=FIT_DT, n_sub=1,
                                  actuation=False)
        pos.append(x[0, 0:5:2])
    return torch.stack(pos).numpy(), acts.numpy(), x0.numpy()


def phase_sim2real(dev):
    """``competition/sim2real.py::fit_quad3d_params`` on the card: the
    synthetic flight fitted over FIT_CANDIDATES candidates (a warm-up fit,
    then one timed with the counters zeroed just before and read just
    after: K1 once a recorded step, nothing else), the bars of
    tests/test_sim2real.py (thrust/mass within 5%, RMSE < 0.3), and K1 with
    actuation off at B = 4096 bit for bit against its plain version on the
    fit's own inputs."""
    import torch

    from safe_control_gym_torch.competition import sim2real as S

    pos, acts, x0 = synthetic_flight()
    S.fit_quad3d_params(pos, acts, FIT_DT, x0, num_candidates=FIT_CANDIDATES, device=dev)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    fit = S.fit_quad3d_params(pos, acts, FIT_DT, x0, num_candidates=FIT_CANDIDATES, device=dev)
    fit_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    ratio, truth = fit["kf_scale"] / fit["mass"], FIT_KF / FIT_MASS
    check("sim2real fit (4096 candidates): K1 once a recorded step",
          launches["k1"] == FIT_T and sum(launches.values()) == FIT_T,
          f"launches {launches} over {FIT_T} steps")
    check("sim2real fit recovers the synthetic flight (tests/test_sim2real.py's bars)",
          abs(ratio - truth) / truth < 0.05 and fit["rmse"] < 0.3,
          f"{fit}; thrust/mass {ratio:.5g} against {truth:.5g}")
    with K1Recorder(S, stride=FIT_K1_STRIDE) as rec:
        S.fit_quad3d_params(pos, acts, FIT_DT, x0, num_candidates=FIT_CANDIDATES, device=dev)
    k1 = k1_small("the fit", dev, rec.inputs)
    print(f"  sim2real fit: {fit_ms:.3f} ms for {FIT_CANDIDATES} candidates x {FIT_T} steps, "
          f"mass {fit['mass']:.5g}, kf {fit['kf_scale']:.5g}, rmse {fit['rmse']:.4g}; K1 at "
          f"B={FIT_CANDIDATES} (no actuation, one substep) {k1['ms'] * 1e3:.4f} us a launch "
          f"(empty kernel {k1['empty_kernel_ms'] * 1e3:.4f} us), plain {k1['plain_ms']:.4f} ms; "
          f"{card_line()}", flush=True)
    return {**fit, "fit_ms": fit_ms, "launches": launches, "k1": k1,
            "thrust_mass_ratio": ratio}


# The experiment workflow (phase_experiment): BASELINE config 4 at the
# rl_train shapes of phase_train, through ConfigFactory and the registry.
EXPERIMENT_TRACE_STEPS = 3  # train steps under device_trace, logged
RESUME_BEFORE, RESUME_AFTER = 2, 1  # train steps before save and after load
EXPERIMENT_EVAL_ENVS = B_MAIN  # ppo.run's episodes (general engine, K1 a step)
GUI_EPISODE_S = 0.5  # level 0's sim-only episode under gui=True, cut short
GUI_EVERY = 2


def state_tensors(obj, seen=None):
    """Every tensor reachable from a learner's state (dataclasses, modules,
    optimizers, dicts, lists), in a fixed order, each object once."""
    import torch

    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj.detach()]
    if isinstance(obj, torch.nn.Module):
        return [t.detach() for t in obj.state_dict().values()]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in state_tensors(obj[k], seen)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in state_tensors(v, seen)]
    if hasattr(obj, "__dict__"):
        return [t for k in sorted(vars(obj)) for t in state_tensors(vars(obj)[k], seen)]
    return []


def states_differ(a, b):
    """The tensors of two learners' states that are not bit for bit equal
    (compared as bytes: the packed rows carry int32 seeds as float32 bit
    patterns, some of them NaNs), and their count (a count mismatch is one
    difference)."""
    import torch

    ta, tb = state_tensors(a), state_tensors(b)
    if len(ta) != len(tb):
        return [f"{len(ta)} tensors against {len(tb)}"], len(ta)

    def raw(t):
        return t.reshape(-1).view(torch.uint8)

    bad = [i for i, (x, y) in enumerate(zip(ta, tb))
           if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(raw(x), raw(y))]
    return bad, len(ta)


def env_state_to(state, device):
    """An env-state dataclass with every tensor (dicts of them included) on
    ``device``."""
    import dataclasses

    def to(v):
        return {k: to(u) for k, u in v.items()} if isinstance(v, dict) else v.to(device)

    return type(state)(**{f.name: to(getattr(state, f.name)) for f in dataclasses.fields(state)})


def experiment_config(out_dir):
    """The run config a user of the reference builds: ``--algo ppo --task
    quadrotor --seed 0`` over the registry's defaults, the task config
    BASELINE config 4 as a dict (its ``dtype``, a torch dtype, which YAML
    does not hold, left at the default float32) with the normalized action
    space of phase_train, and phase_train's train sizes with the fast
    rollout."""
    import dataclasses

    from safe_control_gym_torch.utils.configuration import ConfigFactory

    task = {k: v for k, v in dataclasses.asdict(cfg4()).items() if k != "dtype"}
    algo = dict(rollout_batch_size=TRAIN_B, rollout_steps=TRAIN_T, opt_epochs=EPOCHS,
                mini_batch_size=MB, hidden_dim=HIDDEN, use_fast_rollout=True,
                reshuffle_each_epoch=False)
    return ConfigFactory().merge(
        args=["--algo", "ppo", "--task", "quadrotor", "--seed", "0", "--tag", "phase_experiment",
              "--output_dir", out_dir],
        config_override={"task_config": {**task, "normalized_rl_action_space": True},
                         "algo_config": algo})


def phase_experiment(dev):
    """The reference's experiment workflow on the card at config 4's full
    width (B = 4096, T = 128, H = 64, 10 epochs of 4 minibatches), in a
    temporary directory: ``ConfigFactory`` -> ``set_dir_from_config`` ->
    ``make("quadrotor")`` / ``make("ppo")``; one train step of the registry's
    PPO and of a directly built one (phase_train's) bit for bit, with K3 once
    and K4 forty times each, and their device operations counted alike
    (``profile_launches``); three train steps under ``device_trace``, logged
    by ``ExperimentLogger`` and timed by ``ThroughputMeter``, whose
    ``summarize_kernels`` sees K3 3 times and K4 120 times; fault (g): 2
    train steps, ``save``, ``load`` into a fresh PPO, 1 more, bit-equal to 3
    uninterrupted (parameters, Adam moments, total_steps, the generator);
    ``ppo.run`` on the general engine (K1 once a step); ``GymEnv.render`` on
    the card against the CPU from the same state; ``getting_started.run``
    on level 0 with ``gui=True`` recording its gif."""
    import tempfile

    import torch

    from safe_control_gym_torch import make
    from safe_control_gym_torch.competition.getting_started import run as competition_run
    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.envs.gym_adapter import make_gym_env
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.utils.logging import ExperimentLogger
    from safe_control_gym_torch.utils.profiling import (ThroughputMeter, device_trace,
                                                        summarize_kernels)
    from safe_control_gym_torch.utils.utils import set_dir_from_config

    t_phase = time.perf_counter()
    res = {}
    steps_per_train = EPOCHS * N_MINI
    with tempfile.TemporaryDirectory() as tmp:
        config = experiment_config(tmp)
        run_dir = set_dir_from_config(config)
        env = make(config.task, device=dev, **config.task_config)

        def registry_ppo():
            return make(config.algo, env, seed=config.seed, **config.algo_config)

        def step(p):
            p.state, _ = p._train_step(p.state)

        ppo = registry_ppo()
        direct = PPO(make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev), seed=0,
                     rollout_batch_size=TRAIN_B, rollout_steps=TRAIN_T, opt_epochs=EPOCHS,
                     mini_batch_size=MB, hidden_dim=HIDDEN, use_fast_rollout=True,
                     reshuffle_each_epoch=False)
        check("experiment: the registry's PPO takes K3 and K4, as phase_train's does",
              ppo._fp is not None and ppo._fu is not None and type(ppo._fp) is type(direct._fp)
              and ppo.cfg == direct.cfg and os.path.isfile(os.path.join(run_dir, "config.yaml")),
              f"{type(ppo._fp).__name__}, K4 {ppo._fu is not None}, config {ppo.cfg}; run dir "
              f"{os.path.relpath(run_dir, tmp)}")

        # -- one train step each, the counters zeroed just before.
        torch.cuda.synchronize()
        zero_counters()
        step(ppo)
        step(direct)
        torch.cuda.synchronize()
        launches = read_counters()
        others = sum(v for k, v in launches.items() if k not in ("k3", "k4"))
        check("experiment: one train step of each PPO went through K3 and K4",
              launches["k3"] == 2 and launches["k4"] == 2 * steps_per_train and others == 0,
              f"launches {launches} in 2 train steps")
        bad, n = states_differ(ppo.state, direct.state)
        check("experiment: the registry's train step is bit-equal to the direct one",
              not bad and ppo.state.total_steps == direct.state.total_steps
              and torch.equal(ppo.gen.get_state(), direct.gen.get_state()),
              f"{n} state tensors (parameters, Adam moments, normalizers, env rows), differing: "
              f"{bad}")

        # -- device operations of a train step, then the host clock, in turns.
        ops = {}
        for tag, p in (("registry", ppo), ("direct", direct)):
            ops[tag] = profile_launches(lambda: step(p))
        check("experiment: a train step launches as many device operations either way",
              ops["registry"][0] == ops["direct"][0] and ops["registry"][0] > 0,
              f"registry {ops['registry'][0]}, direct {ops['direct'][0]}")
        wall = {"registry": [], "direct": []}
        for tag, p in (("registry", ppo), ("direct", direct), ("direct", direct),
                       ("registry", ppo)):
            t0 = time.perf_counter()
            step(p)
            torch.cuda.synchronize()
            wall[tag].append((time.perf_counter() - t0) * 1e3)
        bad, _ = states_differ(ppo.state, direct.state)
        check("experiment: still bit-equal after 4 train steps each", not bad,
              f"differing: {bad}")
        res["train_step"] = {tag: {"wall_ms": wall[tag], "device_ms": ops[tag][1],
                                   "device_operations": ops[tag][0], "top": ops[tag][2]}
                             for tag in wall}

        # -- three train steps under device_trace, logged and metered.
        logger = ExperimentLogger(run_dir, log_std_out=False)
        meter = ThroughputMeter()
        trace_dir = os.path.join(run_dir, "trace")
        n_env = EXPERIMENT_TRACE_STEPS * TRAIN_B * TRAIN_T
        for _ in range(TRAIN_PROFILE_SESSIONS):
            zero_counters()
            with device_trace(trace_dir):
                with meter.measure(n_env, sync_on=ppo.state.obs):
                    ppo.learn(max_env_steps=n_env,
                              log_fn=lambda s, m: logger.add_scalars(m, s, prefix="train"))
            launches = read_counters()
            rows = summarize_kernels(trace_dir, top=100_000)
            k3 = [r for r in rows if "quad3d_policy_rollout_kernel" in r["name"]]
            k4 = [r for r in rows if "ppo_grads_kernel" in r["name"]]
            seen = ([r["count"] for r in k3], [r["count"] for r in k4])
            if seen == ([EXPERIMENT_TRACE_STEPS], [EXPERIMENT_TRACE_STEPS * steps_per_train]):
                break
            print(f"  device_trace: K3 {seen[0]}, K4 {seen[1]} in a session; tracing again",
                  flush=True)
        logger.dump_scalars()
        logger.close()
        check("experiment: summarize_kernels of the trace sees K3 3 times and K4 120 times",
              seen == ([EXPERIMENT_TRACE_STEPS], [EXPERIMENT_TRACE_STEPS * steps_per_train])
              and launches["k3"] == EXPERIMENT_TRACE_STEPS
              and launches["k4"] == EXPERIMENT_TRACE_STEPS * steps_per_train,
              f"trace {seen}; counters {launches}; top {[(r['name'][:50], r['count']) for r in rows[:4]]}")
        logged = os.path.join(run_dir, "logs", "train_policy_loss.log")
        with open(logged) as f:
            n_rows = len(f.read().splitlines())
        check("experiment: ExperimentLogger wrote a row a train step", n_rows >= EXPERIMENT_TRACE_STEPS,
              f"{n_rows} rows in logs/train_policy_loss.log")
        res["trace"] = {"k3": k3, "k4": k4, "top": rows[:8],
                        "env_steps_per_s": meter.steps_per_sec, "meter_steps": meter.steps}

        # -- fault (g): save, load into a fresh PPO, train on.
        straight = registry_ppo()
        for _ in range(RESUME_BEFORE + RESUME_AFTER):
            step(straight)
        first = registry_ppo()
        for _ in range(RESUME_BEFORE):
            step(first)
        path = os.path.join(run_dir, "checkpoint.pkl")
        first.save(path)
        del first
        resumed = registry_ppo()
        gen = resumed.gen
        resumed.load(path)
        for _ in range(RESUME_AFTER):
            step(resumed)
        torch.cuda.synchronize()
        bad, n = states_differ(straight.state, resumed.state)
        check("experiment: save, load, train is bit-equal to the uninterrupted run (fault (g))",
              not bad and resumed.gen is gen
              and straight.state.total_steps == resumed.state.total_steps
              == (RESUME_BEFORE + RESUME_AFTER) * TRAIN_B * TRAIN_T
              and straight.state.actor_opt.count == resumed.state.actor_opt.count
              and torch.equal(straight.gen.get_state(), resumed.gen.get_state()),
              f"{n} state tensors, differing {bad}; total_steps {resumed.state.total_steps}, "
              f"Adam count {resumed.state.actor_opt.count}")
        del straight, resumed, direct

        # -- evaluation on the general engine: K1 once a step, nothing else.
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        ev = ppo.run(num_episodes=EXPERIMENT_EVAL_ENVS)
        eval_s = time.perf_counter() - t0
        launches = read_counters()
        T_ev = ev["reward"].shape[0]
        check("experiment: ppo.run evaluates on the general engine, K1 once a step",
              launches["k1"] == T_ev == env.max_episode_steps
              and sum(launches.values()) == T_ev
              and ev["ep_returns"].shape == (EXPERIMENT_EVAL_ENVS,)
              and bool(np.isfinite(ev["ep_returns"]).all()),
              f"launches {launches} in {T_ev} steps; mean return {ev['ep_returns'].mean():.4g}")
        res["eval"] = {"envs": EXPERIMENT_EVAL_ENVS, "steps": T_ev, "s": eval_s,
                       "launches": launches, "mean_return": float(ev["ep_returns"].mean())}

        # -- GymEnv.render on the card against the CPU from the same state.
        genv, cenv = make_gym_env(cfg4(), device=dev), make_gym_env(cfg4(), device="cpu")
        genv.reset()
        cenv.reset()
        for _ in range(3):
            genv.step(np.asarray(genv.u_goal, np.float32))
        cenv._state = env_state_to(genv.state, torch.device("cpu"))
        frame, frame_cpu = genv.render(), cenv.render()
        check("experiment: GymEnv.render on the card equals the CPU env's frame",
              frame.ndim == 3 and frame.shape[-1] == 3 and frame.dtype == np.uint8
              and np.array_equal(frame, frame_cpu) and bool((frame < 250).any()),
              f"frame {frame.shape} {frame.dtype}")

        # -- the competition loop with gui=True: no display here, so the
        # viewer records the episode to gui_episode0.gif in the working
        # directory.
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            ep = competition_run(load_level(0, episode_len_sec=GUI_EPISODE_S), num_episodes=1,
                                 use_firmware=False, ctrl_freq=COMP_SIM_FREQ, gui=True,
                                 gui_every=GUI_EVERY, device=dev)[0]
            gui_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        gif = os.path.join(tmp, "gui_episode0.gif")
        check("experiment: getting_started.run(gui=True) records its gif",
              os.path.isfile(gif) and os.path.getsize(gif) > 0
              and ep["steps"] == int(GUI_EPISODE_S * COMP_SIM_FREQ),
              f"{ep['steps']} steps, gif {os.path.getsize(gif) if os.path.isfile(gif) else 0} "
              "bytes")
        res["gui"] = {"steps": ep["steps"], "s": gui_s,
                      "gif_bytes": os.path.getsize(gif)}

    res["phase_s"] = time.perf_counter() - t_phase
    ts = res["train_step"]
    print(f"  experiment (config 4, B={TRAIN_B}, T={TRAIN_T}, H={HIDDEN}): train step through "
          f"the registry wall {ts['registry']['wall_ms']} ms, device "
          f"{ts['registry']['device_ms']:.3f} ms, {ts['registry']['device_operations']} device "
          f"operations; built directly wall {ts['direct']['wall_ms']} ms, device "
          f"{ts['direct']['device_ms']:.3f} ms, {ts['direct']['device_operations']} device "
          f"operations; {card_line()}", flush=True)
    print(f"  experiment: ThroughputMeter {res['trace']['env_steps_per_s']:.6g} env-steps/s over "
          f"{res['trace']['meter_steps']} env steps under device_trace; eval "
          f"{EXPERIMENT_EVAL_ENVS} episodes of {res['eval']['steps']} steps in "
          f"{res['eval']['s']:.2f} s; gui episode {res['gui']['steps']} steps in "
          f"{res['gui']['s']:.2f} s; phase {res['phase_s']:.1f} s; {card_line()}", flush=True)
    return res


# The distributed path (parallel/mesh.py, distributed.py, dryrun.py,
# _multihost_worker.py): config 4 at B_MAIN for DIST_STEPS general-engine
# steps and one train step at the rl_train shapes in a one-rank NCCL group in
# this process, then DIST_RANKS gloo ranks sharing the card.
DIST_STEPS = GENERAL_STEPS
DIST_RANKS = 2
DIST_WORKER_STEPS = 40  # the validation worker's rollout (its default)
DIST_ALLREDUCE_REPS = 50
DIST_STATS_RTOL = 1e-5  # tests/test_multihost.py:66-70


def dist_policy(dev, hover):
    import torch

    def policy(pstate, obs):  # the batch comes from obs: a rank sees its slice
        return torch.full((obs.shape[0], 4), hover, device=dev), pstate

    return policy


def phase_distributed(dev):
    """(a) The NCCL path at world size 1 in this process: config 4's sharded
    rollout at B_MAIN through K1 against the unsharded rollout (every env's
    state bit for bit, the statistics equal), one sharded PPO train step at
    the rl_train shapes (K4 forty times) against ``ppo._train_step`` with
    the same sample normals and permutations (parameters and Adam moments
    bit for bit), an all-reduce of K4's gradients timed, and the validation
    worker's statistics at B_MAIN.  (b) DIST_RANKS gloo ranks on the one
    card (``launch_workers(..., device="cuda")``, the kernels built by
    phase_build before they start): ``dryrun_multichip`` at 1024 envs a rank
    (the sharded PPO step, K2 bit-equal to sequential calls, K4's all-reduced
    gradients against the sequential sum, each asserted in every rank) and
    the validation worker at B_MAIN, whose statistics must equal (a)'s.  A
    failing rank fails the phase; nothing is caught."""
    import tempfile

    import torch
    import torch.distributed as dist

    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import _multihost_worker as MW
    from safe_control_gym_torch.parallel import distributed as D
    from safe_control_gym_torch.parallel import dryrun
    from safe_control_gym_torch.parallel.mesh import all_reduce_sum
    from safe_control_gym_torch.parallel.rollout import (
        EpisodeStats, RolloutCarry, rollout, sharded_rollout_fn)
    from safe_control_gym_torch.parallel.vector import make_vec_env

    t_phase = time.perf_counter()
    res = {"card": card_line()}
    axes = (D.HOST_AXIS, D.CHIP_AXIS)
    # One rank needs no network: NCCL's bootstrap listens on loopback.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        D.initialize(f"file://{tmp}/store", world_size=1, rank=0, device=dev, timeout=300)
        try:
            check("distributed (a): a one-rank group on the backend of the rule (NCCL on a card)",
                  dist.get_backend() == D.backend_for(dev, 1) and dist.get_world_size() == 1,
                  f"backend {dist.get_backend()}")
            mesh = D.host_mesh()
            env = make_quadrotor(cfg4(), device=dev)
            vec = make_vec_env(env, B_MAIN)
            policy = dist_policy(dev, float(env.u_goal[0]))

            def unsharded():
                state, obs, _ = vec.reset(seed=0)
                carry = RolloutCarry(state, obs, (), EpisodeStats.create(B_MAIN, device=dev))
                carry, _ = rollout(vec, policy, carry, DIST_STEPS, collect=False)
                return carry, carry.stats.means()

            def sharded():
                run = sharded_rollout_fn(vec, policy, DIST_STEPS, mesh, axis_name=axes)
                return run(D.sharded_init_fn(env, B_MAIN, mesh)(seed=0))

            walls, runs = {"unsharded": [], "sharded": []}, {}
            for tag in ("unsharded", "sharded", "sharded", "unsharded"):  # in turns
                zero_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[tag] = (sharded if tag == "sharded" else unsharded)()
                torch.cuda.synchronize()
                walls[tag].append(time.perf_counter() - t0)
                runs[tag] += (read_counters(),)
            (ref, ref_stats, _), (got, stats, n_roll) = runs["unsharded"], runs["sharded"]
            bad, n = states_differ(got.env_state, ref.env_state)
            check(f"distributed (a): sharded rollout, config 4, B={B_MAIN}, {DIST_STEPS} steps, "
                  "against the unsharded rollout",
                  not bad and stats == ref_stats and n_roll["k1"] == DIST_STEPS,
                  f"{n} state tensors bit for bit (differ: {bad}); stats {stats}; K1 "
                  f"{n_roll['k1']} launches")
            res["rollout"] = {"batch": B_MAIN, "steps": DIST_STEPS, "stats": stats,
                              "sharded_s": walls["sharded"], "unsharded_s": walls["unsharded"],
                              "launches": n_roll}

            # One train step at the rl_train shapes, both ways, the same draws.
            tenv = make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev)
            kw = dict(rollout_batch_size=TRAIN_B, rollout_steps=TRAIN_T, opt_epochs=EPOCHS,
                      mini_batch_size=MB, hidden_dim=HIDDEN)
            gen = torch.Generator(device=dev).manual_seed(5)
            eps = torch.randn((TRAIN_T, TRAIN_B, 4), generator=gen, device=dev)
            perm = torch.stack([torch.randperm(TRAIN_B * TRAIN_T, generator=gen, device=dev)
                                for _ in range(EPOCHS)])

            def train(tag):
                """One train step of a fresh PPO, sharded or not, its wall
                and its launches."""
                ppo = PPO(tenv, seed=0, **kw)
                state = D.shard_ppo_state(ppo, mesh) if tag == "sharded" else ppo.state
                zero_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if tag == "sharded":
                    D.sharded_train_step(ppo, state, mesh, eps=eps, perm=perm)
                else:
                    ppo._train_step(state, eps=eps, perm=perm)
                torch.cuda.synchronize()
                return state, time.perf_counter() - t0, read_counters()

            steps = {"unsharded": [], "sharded": []}
            for tag in ("unsharded", "sharded", "sharded", "unsharded"):  # in turns
                steps[tag].append(train(tag))
            (ref_state, _, _), (state, _, n_train) = steps["unsharded"][0], steps["sharded"][0]
            bad, n = states_differ(state, ref_state)
            sharded_ms = [r[1] * 1e3 for r in steps["sharded"]]
            unsharded_ms = [r[1] * 1e3 for r in steps["unsharded"]]
            check(f"distributed (a): sharded PPO train step (B={TRAIN_B}, T={TRAIN_T}, "
                  f"H={HIDDEN}) against _train_step",
                  not bad and not states_differ(steps["sharded"][1][0], ref_state)[0]
                  and n_train["k4"] == EPOCHS * N_MINI and n_train["k1"] == TRAIN_T,
                  f"{n} state tensors bit for bit (differ: {bad}); K4 {n_train['k4']}, K1 "
                  f"{n_train['k1']} launches; walls in turns {sharded_ms} ms sharded, "
                  f"{unsharded_ms} ms unsharded")
            grads = torch.cat([p.detach().reshape(-1) for p in state.ac.parameters()])
            all_reduce_sum(grads, dist.group.WORLD)
            nccl_ms = cuda_ms(lambda: all_reduce_sum(grads, dist.group.WORLD),
                              DIST_ALLREDUCE_REPS)
            res["train_step"] = {"batch": TRAIN_B, "steps": TRAIN_T, "sharded_ms": sharded_ms,
                                 "unsharded_ms": unsharded_ms, "launches": n_train,
                                 "allreduce_k4_grads_ms": nccl_ms, "k4_grad_floats": grads.numel()}
            worker_ref = MW.stats(B_MAIN, DIST_WORKER_STEPS, dev, mesh)
        finally:
            dist.destroy_process_group()
    check("distributed (a): the group is destroyed", not dist.is_initialized(), "")

    # (b) DIST_RANKS gloo ranks on the one card.
    t0 = time.perf_counter()
    mc = dryrun.dryrun_multichip(DIST_RANKS, device=dev, timeout=600.0)
    mc_s = time.perf_counter() - t0
    check("distributed (b): dryrun_multichip on 2 gloo ranks sharing the card",
          mc["backend"] == "gloo" and mc["k2"]["bit_equal"] and mc["launches"]["k2"] == DIST_RANKS
          and mc["launches"]["k4"] > 0 and mc["launches"]["k1"] > 0,
          f"K2 {mc['k2']['episodes']:.0f} episodes bit-equal, K4 all-reduced within "
          f"{mc['k4']['max_abs_err']:.3g}, launches {mc['launches']}")
    t0 = time.perf_counter()
    worker = D.result_line(D.launch_workers(
        dryrun.WORKER, 1, DIST_RANKS, device=dev.type, timeout=600.0,
        env_overrides={"SCG_TEST_NUM_ENVS": str(B_MAIN),
                       "SCG_TEST_NUM_STEPS": str(DIST_WORKER_STEPS)}), "MULTIHOST_STATS ")
    worker_s = time.perf_counter() - t0
    close = all(abs(worker[k] - worker_ref[k]) <= DIST_STATS_RTOL * abs(worker_ref[k])
                for k in ("mean_return", "mean_length", "mean_violations"))
    check("distributed (b): the worker on 2 gloo ranks against (a)'s one-rank run",
          worker["episodes"] == worker_ref["episodes"] > 0 and close
          and worker["total_steps"] == worker_ref["total_steps"],
          f"{worker} against {worker_ref} (rtol {DIST_STATS_RTOL:g})")
    res["cluster"] = {"ranks": DIST_RANKS, "dryrun": mc, "dryrun_s": mc_s, "worker": worker,
                      "worker_ref": worker_ref, "worker_s": worker_s}
    res["launches"] = {k: res["rollout"]["launches"][k] + n_train[k] + mc["launches"][k]
                       + worker["launches"][k] for k in ("k1", "k2", "k4")}
    res["phase_s"] = time.perf_counter() - t_phase
    ro, tr = res["rollout"], res["train_step"]
    print(f"  distributed (a), one-rank NCCL group: sharded rollout (B={B_MAIN}, {DIST_STEPS} "
          f"steps) {min(ro['sharded_s']):.3f} s against unsharded {min(ro['unsharded_s']):.3f} s "
          f"(walls {ro['sharded_s']} / {ro['unsharded_s']}); sharded train step "
          f"{min(tr['sharded_ms']):.1f} ms against {min(tr['unsharded_ms']):.1f} ms (walls "
          f"{tr['sharded_ms']} / {tr['unsharded_ms']}); NCCL all-reduce of "
          f"K4's {tr['k4_grad_floats']} gradient floats {tr['allreduce_k4_grads_ms'] * 1e3:.1f} us; "
          f"{card_line()}", flush=True)
    print(f"  distributed (b), {DIST_RANKS} gloo ranks on the card: dryrun_multichip "
          f"{mc_s:.1f} s (gloo all-reduce of K4's gradients {mc['k4']['allreduce_ms']:.3f} ms), "
          f"the worker at B={B_MAIN} {worker_s:.1f} s; launches in the phase {res['launches']}; "
          f"phase {res['phase_s']:.1f} s; {card_line()}", flush=True)
    return res


def sass_instructions(kname):
    """SASS instructions of the kernel instance whose mangled name holds
    ``kname`` in the built library (``scripts/ab_kernel.py::sass_count``,
    which writes its SASS beside the library)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from ab_kernel import sass_count

    from safe_control_gym_torch import kernels

    return sass_count(kernels.LIB, kname, [""], kernels.BUILD / f"{kname}.sass")["instructions"]


# K3's instances whose SASS the maze instances must leave as it was
# (config 4's at H = 64: 4856 instructions before them), by mangled name.
K3_SASS = {"config 4 (H=64)": "quad3d_policy_rollout_kernelILi64ELi8ELb0ELb0E",
           "config 4-GH (observation)": "quad3d_policy_rollout_kernelILi0ELi8ELb1ELb0E",
           "config 5 (maze, H=64)": "quad3d_policy_rollout_kernelILi64ELi8ELb0ELb1E"}


def layout_nx(layout):
    """The state rows of a rows layout (K2_LAYOUT, K5_LAYOUT, k7_layout)."""
    return layout["close"][0][1].stop


def k4_inputs(dev, ac, n, seed=0, nx=12, nu=4):
    """A seeded (nx+nu+4, n) minibatch near the policy ``ac``: ratios spread
    over both sides of the clip range."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    with torch.no_grad():
        obs = 0.5 * rn(n, nx)
        mean, std = ac.actor(obs), torch.exp(ac.logstd)
        act = mean + std * rn(n, nu)
        logp = (-((act - mean) ** 2) / (2 * std**2) - torch.log(std)
                - 0.5 * float(np.log(2 * np.pi))).sum(-1)
        v = ac.critic(obs)[:, 0]
        cols = [obs, act, v[:, None], (logp + 0.3 * rn(n))[:, None],
                (v + rn(n))[:, None], rn(n)[:, None]]
    return torch.cat(cols, 1).T.contiguous()


def k4_autograd(ac, mb, clip):
    """torch.autograd of the reference losses (the minibatch's mean clipped
    surrogate and half its mean squared value error): the gradients K4
    returns, keyed like fast_update.SEGMENTS, and the 3 loss sums."""
    import torch

    from safe_control_gym_torch.parallel import fast_update as U

    nx, nu = ac.actor.layers[0].weight.shape[1], ac.logstd.shape[0]
    obs, act = mb[:nx].T, mb[nx:nx + nu].T
    logp_old, ret, adv = mb[nx + nu + 1], mb[nx + nu + 2], mb[nx + nu + 3]
    params = dict(zip(U.SEGMENTS, [p for net in (ac.actor, ac.critic) for p in net.parameters()]
                      + [ac.logstd]))
    with torch.enable_grad():
        mean, std = ac.actor(obs), torch.exp(ac.logstd)
        logp = (-((act - mean) ** 2) / (2 * std**2) - ac.logstd
                - 0.5 * float(np.log(2 * np.pi))).sum(-1)
        ratio = torch.exp(logp - logp_old)
        min_surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        v = ac.critic(obs)[:, 0]
        loss = -min_surr.mean() + 0.5 * ((v - ret) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
    sums = torch.stack([min_surr.sum(), (logp_old - logp).sum(), ((v - ret) ** 2).sum()])
    return dict(zip(params, grads)), sums.detach()


def check_grads(tag, g, sums, g_ref, sums_ref):
    import torch

    from safe_control_gym_torch.parallel import fast_update as U

    errs = []
    for k in U.SEGMENTS:
        ref = g_ref[k].reshape(g[k].shape)
        scale = float(ref.abs().max())
        atol = min(K4_ATOL, K4_ATOL_REL * scale)
        errs.append(max_err(g[k], ref))
        check(f"K4 {tag}: {k}", bool(torch.isclose(g[k], ref, rtol=K4_RTOL, atol=atol).all()),
              f"max_abs_err {errs[-1]:.3g} against max|ref| {scale:.3g} "
              f"(rtol {K4_RTOL:g}, atol {atol:.3g})")
    ok = bool(torch.isclose(sums, sums_ref, rtol=K4_SUM_RTOL, atol=K4_SUM_ATOL).all())
    check(f"K4 {tag}: loss sums", ok, f"{sums.tolist()} vs {sums_ref.tolist()} "
          f"(rtol {K4_SUM_RTOL:g}, atol {K4_SUM_ATOL:g})")
    return max(errs)


# K4's shapes (nx, nu, H, logstd): the three training paths at the
# rl_train width (config 4, CartPole, quad 2D), config 4 at H = 128, the
# largest observation and action widths the JAX rule sends to its kernel
# (obs_dim 128, act_dim 8), and those at K4's largest width, whose weights
# do not fit in shared memory and whose gradient tiles take five slices.
_LOGSTD8 = [-0.7 + 0.4 * i / 7 for i in range(8)]
K4_SHAPES = {"config4": (12, 4, HIDDEN, [-0.5, -0.7, -0.3, -0.6]),
             "cartpole": (4, 1, HIDDEN, [-0.4]), "quad2d": (6, 2, HIDDEN, [-0.5, -0.3]),
             "config4_h128": (12, 4, 128, [-0.5, -0.7, -0.3, -0.6]),
             "config4_gh": (36, 4, HIDDEN, [-0.5, -0.7, -0.3, -0.6]),
             "obs128_act8": (128, 8, HIDDEN, _LOGSTD8),
             "obs128_act8_h256": (128, 8, 256, _LOGSTD8)}


def phase_k4(dev):
    """K4 at each shape of K4_SHAPES on a seeded minibatch of MB samples:
    against its plain version and torch.autograd, a bit-equal relaunch, its
    device time and the plain version's."""
    import torch

    from safe_control_gym_torch.parallel import fast_update as U

    out = {}
    for tag, (nx, nu, h, logstd) in K4_SHAPES.items():
        ac = seeded_ac(dev, seed=1, nx=nx, nu=nu, hidden=h)
        with torch.no_grad():  # spread logstd so each action dim differs
            ac.logstd.copy_(torch.tensor(logstd, device=dev))
        mb = k4_inputs(dev, ac, MB, nx=nx, nu=nu)
        w = U.prep_weights(ac.actor, ac.critic, ac.logstd)
        g1, s1 = U.ppo_grads(mb, w, clip=0.2)
        g2, s2 = U.ppo_grads(mb, w, clip=0.2)
        gp, sp = U.ppo_grads_plain(mb, w, clip=0.2)
        ga, sa = k4_autograd(ac, mb, 0.2)
        torch.cuda.synchronize()
        shape = f"mb={MB}, nx {nx}, nu {nu}, H {h}"
        same = all(torch.equal(g1[k], g2[k]) for k in U.SEGMENTS) and torch.equal(s1, s2)
        check(f"K4 {tag} two launches on the same input ({shape})", same, "bit-equal")
        res = {"nx": nx, "nu": nu, "H": h,
               "max_abs_err": check_grads(f"{tag} vs plain ({shape})", g1, s1, gp, sp),
               "max_abs_err_vs_autograd": check_grads(f"{tag} vs torch.autograd ({shape})", g1, s1,
                                                      ga, sa),
               "plan": list(U._plans[(nx, nu, h, MB, mb.device.index)]),
               "ms": device_ms(lambda: U.ppo_grads(mb, w, clip=0.2), 20)}
        plain = lambda: U.ppo_grads_plain(mb, w, clip=0.2)  # noqa: E731
        cuda_ms(plain, 3)
        res["plain_ms"] = cuda_ms(plain, 20)
        out[tag] = res
    return out


def phase_k5_k6(dev):
    """K5 and K6 against their plain versions, K5 against the general
    engine, at B = 1024 over CHECK_STEPS steps through auto-resets."""
    import torch

    from safe_control_gym_torch.envs.cartpole import make_cartpole
    from safe_control_gym_torch.parallel import fast_cartpole as FC
    from safe_control_gym_torch.parallel import rollout as R
    from safe_control_gym_torch.parallel.vector import make_vec_env

    res = {"k5_err": 0.0}
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    # K5 on config 2 itself, its action white noise included (10-step episodes).
    env = make_cartpole(cfg_cartpole(episode_len_sec=0.2), device=dev)
    for B in (RAGGED_B, CHECK_B, *plan_batches(FC.GROUPS, FC.PLAN_LANES)):
        fr = FC.FastCartPoleRollout(env, B, CHECK_STEPS, device=dev)
        rows0, act = fr.reset(seed=0), fr.prepare_action(0.3)
        out = FC.cartpole_rollout(fr.params, rows0, act, seed)
        ref = FC.cartpole_rollout_plain(fr.params, rows0, act, seed)
        torch.cuda.synchronize()
        res["k5_err"] = max(res["k5_err"], check_rows(
            f"K5 vs plain (config 2, B={B}, {CHECK_STEPS} steps)", out, ref, rows0, K5_LAYOUT))

    # K5's other branches: the quadratic cost with goal capture on the
    # square curve, an impulse on the cart, a constant force.
    env = make_cartpole(cfg_cartpole(
        episode_len_sec=0.2, cost="quadratic", disturbances=IMPULSE_CP,
        task_info={"trajectory_type": "square", "trajectory_plane": "xz"}), device=dev)
    for B in (RAGGED_B, *plan_batches(FC.GROUPS, FC.PLAN_LANES)):
        fr = FC.FastCartPoleRollout(env, B, CHECK_STEPS, device=dev)
        rows0, act = fr.reset(seed=0), fr.prepare_action(0.3)
        out = FC.cartpole_rollout(fr.params, rows0, act, seed)
        ref = FC.cartpole_rollout_plain(fr.params, rows0, act, seed)
        torch.cuda.synchronize()
        res["k5_err"] = max(res["k5_err"], check_rows(
            f"K5 vs plain (quadratic, square curve, impulse, B={B}, {CHECK_STEPS} steps)",
            out, ref, rows0, K5_LAYOUT))

    # K5 against the general engine, noise-free with an impulse on the cart.
    env = make_cartpole(cfg_cartpole(episode_len_sec=0.2, disturbances=IMPULSE_CP,
                                     randomized_inertial_prop=True), device=dev)
    fr = FC.FastCartPoleRollout(env, CHECK_B, CHECK_STEPS, device=dev)
    vec = make_vec_env(env, CHECK_B)
    state, obs, _ = vec.reset(seed=0)
    rows0 = fr.reset(seed=0)
    check("K5 reset rows vs general-engine reset",
          torch.equal(fr.pack(state).view(torch.int32), rows0.view(torch.int32)), "bit-identical")
    rows = fr.run(rows0, 0.3)
    force = torch.full((CHECK_B, 1), 0.3, device=dev)
    carry, _ = R.rollout(vec, lambda ps, o: (force, ps),
                         R.RolloutCarry(state, obs, (), R.EpisodeStats.create(CHECK_B, device=dev)),
                         CHECK_STEPS, collect=False)
    torch.cuda.synchronize()
    res["k5_cross_err"] = check_cross("K5", rows, carry, 4, [7, 8, 12, 17], "pole_length", 4)

    # K6 on cartpole_stab (10-step episodes), then tracking the circle with
    # config 2's action white noise and an impulse on the cart: at every
    # group the kernel is built for and every batch its plan takes apart.
    errs = []
    for tag, cfg in (("K6", cfg_cartpole_rl(episode_len_sec=0.2)),
                     ("K6 (action noise, impulse, circle)", cfg_cartpole_rl(
                         episode_len_sec=0.2, disturbances={**IMPULSE_CP, **ACT_NOISE_CP},
                         **TRACK_CIRCLE))):
        env = make_cartpole(cfg, device=dev)
        errs.append(check_policy_groups(
            tag, lambda B, h: FC.FastCartPolePolicyRollout(env, B, CHECK_STEPS, mlp_hidden=h,
                                                           device=dev),
            FC.cartpole_policy_rollout, FC.cartpole_policy_rollout_plain, K5_LAYOUT, 4, 1,
            FC.POLICY_GROUPS, FC.POLICY_PLAN_LANES))
    res["k6_err"], res["k6_differ"] = max(e for e, _ in errs), max(d for _, d in errs)
    return res


def check_cross(tag, rows, carry, nx, exact, inertia_field, inertia_row):
    """A whole-rollout kernel's rows against the general engine's state and
    statistics after the same steps from the same env seeds: done counts,
    episode, step and offset rows exactly, states at the JAX suite's
    tolerance, the first inertia row relatively."""
    import torch

    step, offset, done, ep = exact
    es = carry.env_state
    check(f"{tag} vs general engine: done counts", torch.equal(rows[done], carry.stats.done_count.float()),
          f"{int(rows[done].sum())} vs {int(carry.stats.done_count.sum())} episodes")
    same = (torch.equal(rows[ep], es.episode_idx.float()) and torch.equal(rows[step], es.ctrl_step.float())
            and torch.equal(rows[offset], es.dist_offsets["dynamics"][:, 0].float()))
    check(f"{tag} vs general engine: episode, step and offset rows", same, "exact")
    err = max_err(rows[:nx].T, es.x)
    close = bool(torch.isclose(rows[:nx].T, es.x, rtol=2e-4, atol=2e-5).all()) and \
        bool(torch.isclose(rows[inertia_row], getattr(es, inertia_field), rtol=1e-6, atol=0).all())
    check(f"{tag} vs general engine: states and inertia", close,
          f"max_abs_err {err:.3g} (rtol 2e-4, atol 2e-5)")
    return err


def phase_k7_k8(dev):
    """K7 and K8 on the 1D and 2D quads against their plain versions, K7
    against the general engine, at B = 1024 over CHECK_STEPS steps through resets."""
    import torch

    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ
    from safe_control_gym_torch.parallel import rollout as R
    from safe_control_gym_torch.parallel.vector import make_vec_env

    res = {"k7_err": 0.0, "k7_cross_err": 0.0, "k8_err": 0.0, "k8_differ": 0.0}
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    impulse = {"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.02, "duration": 4,
                             "decay_rate": 0.8},)}
    noisy = {**impulse, "action": ({"disturbance_func": "white_noise", "std": 0.001},)}
    noisy_k8 = {**impulse, "action": ({"disturbance_func": "white_noise", "std": 0.01},)}
    for qt in (1, 2):
        nx, nu = PQ.nx_nu(qt)
        lay = k7_layout(nx)
        # K7 with the action white noise and the impulse (10-step episodes).
        env = make_quadrotor(cfg_quad2d(quad_type=qt, episode_len_sec=0.2, disturbances=noisy),
                             device=dev)
        for B in (RAGGED_B, CHECK_B, *plan_batches(PQ.GROUPS, PQ.PLAN_LANES)):
            fr = PQ.FastPlanarQuadRollout(env, B, CHECK_STEPS, device=dev)
            rows0 = fr.reset(seed=0)
            act = fr.prepare_action(np.full(nu, 1.1 * float(env.u_goal[0]), np.float32))
            out = PQ.planar_rollout(fr.params, rows0, act, seed)
            ref = PQ.planar_rollout_plain(fr.params, rows0, act, seed)
            torch.cuda.synchronize()
            res["k7_err"] = max(res["k7_err"], check_rows(
                f"K7 {qt}D vs plain (B={B}, {CHECK_STEPS} steps)", out, ref, rows0, lay))

        # K7 without action noise, as config 3 runs (impulse only,
        # randomized mass and inertia, 10-step episodes): the constant
        # command's forces and body held over steps and made again after
        # each reset, at every group size.
        env = make_quadrotor(cfg_quad2d(quad_type=qt, episode_len_sec=0.2, disturbances=impulse),
                             device=dev)
        for B in (RAGGED_B, *plan_batches(PQ.GROUPS, PQ.PLAN_LANES)):
            fr = PQ.FastPlanarQuadRollout(env, B, CHECK_STEPS, device=dev)
            rows0 = fr.reset(seed=0)
            act = fr.prepare_action(np.full(nu, 1.1 * float(env.u_goal[0]), np.float32))
            out = PQ.planar_rollout(fr.params, rows0, act, seed)
            ref = PQ.planar_rollout_plain(fr.params, rows0, act, seed)
            torch.cuda.synchronize()
            res["k7_err"] = max(res["k7_err"], check_rows(
                f"K7 {qt}D vs plain (no action noise, B={B}, {CHECK_STEPS} steps)", out, ref,
                rows0, lay))

        # K7's other branches: Euler substeps, the quadratic cost on the
        # circle, action noise and the impulse.
        env = make_quadrotor(cfg_quad2d(
            quad_type=qt, episode_len_sec=0.2, disturbances=noisy, physics="dyn",
            cost="quadratic", task="traj_tracking",
            task_info={"trajectory_type": "circle", "trajectory_plane": "xz"}), device=dev)
        for B in (RAGGED_B, *plan_batches(PQ.GROUPS, PQ.PLAN_LANES)):
            fr = PQ.FastPlanarQuadRollout(env, B, CHECK_STEPS, device=dev)
            rows0 = fr.reset(seed=0)
            act = fr.prepare_action(np.full(nu, 1.1 * float(env.u_goal[0]), np.float32))
            out = PQ.planar_rollout(fr.params, rows0, act, seed)
            ref = PQ.planar_rollout_plain(fr.params, rows0, act, seed)
            torch.cuda.synchronize()
            res["k7_err"] = max(res["k7_err"], check_rows(
                f"K7 {qt}D vs plain (Euler, quadratic, circle, B={B}, {CHECK_STEPS} steps)",
                out, ref, rows0, lay))

        # K7 against the general engine, noise-free.
        env = make_quadrotor(cfg_quad2d(quad_type=qt, episode_len_sec=0.2, disturbances=impulse),
                             device=dev)
        fr = PQ.FastPlanarQuadRollout(env, CHECK_B, CHECK_STEPS, device=dev)
        vec = make_vec_env(env, CHECK_B)
        state, obs, _ = vec.reset(seed=0)
        rows0 = fr.reset(seed=0)
        check(f"K7 {qt}D reset rows vs general-engine reset",
              torch.equal(fr.pack(state).view(torch.int32), rows0.view(torch.int32)), "bit-identical")
        hover = float(env.u_goal[0])
        rows = fr.run(rows0, np.full(nu, 1.1 * hover, np.float32))
        thrust = torch.full((CHECK_B, nu), 1.1 * hover, device=dev)
        carry, _ = R.rollout(vec, lambda ps, o: (thrust, ps), R.RolloutCarry(
            state, obs, (), R.EpisodeStats.create(CHECK_B, device=dev)), CHECK_STEPS, collect=False)
        torch.cuda.synchronize()
        res["k7_cross_err"] = max(res["k7_cross_err"], check_cross(
            f"K7 {qt}D", rows, carry, nx, lay["exact"], "mass", nx))

        # K8 on quad stabilization with the normalized action space, then
        # tracking the circle with action white noise and the impulse (the
        # noise terms drawn ahead, the thrusts actuated every step): at
        # every group the kernel is built for and every batch its plan
        # takes apart.
        for tag, cfg in ((f"K8 {qt}D", cfg_quad2d_rl(quad_type=qt, episode_len_sec=0.2)),
                         (f"K8 {qt}D (action noise, impulse, circle)", cfg_quad2d_rl(
                             quad_type=qt, episode_len_sec=0.2, disturbances=noisy_k8,
                             **TRACK_CIRCLE))):
            env = make_quadrotor(cfg, device=dev)
            err, differ = check_policy_groups(
                tag, lambda B, h: PQ.FastPlanarQuadPolicyRollout(env, B, CHECK_STEPS, mlp_hidden=h,
                                                                 device=dev),
                PQ.planar_policy_rollout, PQ.planar_policy_rollout_plain, lay, nx, nu,
                PQ.POLICY_GROUPS, PQ.POLICY_PLAN_LANES)
            res["k8_err"], res["k8_differ"] = max(res["k8_err"], err), max(res["k8_differ"], differ)
    return res


def serve(dev, tag, env, fr, act, kernel, plain, kname, key, layout, done_row,
          plain_steps=PLAIN_STEPS):
    """One serving path at B = 4096: the general engine for
    SERVE_GENERAL_STEPS steps of ``act``'s command, then the whole-rollout
    engine's timed call after two warm-ups, the kernel against its plain
    version on a ``plain_steps``-step call from the timed call's rows, and
    the kernel's device time."""
    import torch

    from safe_control_gym_torch.parallel import rollout as R
    from safe_control_gym_torch.parallel.vector import make_vec_env

    res = {}
    vec = make_vec_env(env, B_MAIN)
    command = act.T.contiguous()
    state, obs, _ = vec.reset(seed=0)
    carry0 = R.RolloutCarry(state, obs, (), R.EpisodeStats.create(B_MAIN, device=dev))
    general = lambda: R.rollout(vec, lambda ps, o: (command, ps), carry0,  # noqa: E731
                                SERVE_GENERAL_STEPS, collect=False)[0]
    general()
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    carry = general()
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    res["general_launches"] = read_counters()
    check(f"{tag} general engine output", bool(torch.isfinite(carry.env_state.x).all()),
          f"finite states; {carry.stats.means()}; launches {res['general_launches']}")
    res["general_env_steps_s"] = B_MAIN * SERVE_GENERAL_STEPS / t_gen

    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    rows_in = fr.run(fr.run(fr.reset(seed=0), act, seed=1), act, seed=2)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    rows = fr.run(rows_in, act, seed=seed)
    torch.cuda.synchronize()
    t_fast = time.perf_counter() - t0
    res["launches"] = read_counters()
    others = sum(v for k, v in res["launches"].items() if k != key)
    check(f"{tag} whole-rollout call went through {kname}",
          res["launches"][key] == 1 and others == 0, f"launches {res['launches']}")
    check(f"{tag} whole-rollout output", bool(torch.isfinite(rows[:layout['seed']]).all()),
          f"finite rows; {fr.stats(rows)}")
    res["fast_env_steps_s"] = B_MAIN * fr.steps / t_fast
    res["fast_call_ms"] = t_fast * 1e3
    res["resets"] = float(rows[done_row].sum() - rows_in[done_row].sum())

    p_short = dict(fr.params, steps=plain_steps)
    out = kernel(p_short, rows_in, act, seed)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = plain(p_short, rows_in, act, seed)
    end.record()
    torch.cuda.synchronize()
    res["plain_ms"] = start.elapsed_time(end)
    res["main_max_abs_err"] = check_rows(
        f"{kname} vs plain from the main path's rows (B={B_MAIN}, {plain_steps} steps)", out, ref,
        rows_in, layout)
    res["ms"] = device_ms(lambda: kernel(fr.params, rows_in, act, seed), 5)
    res["plain_steps"] = plain_steps
    return res


def phase_serve_cartpole(dev):
    from safe_control_gym_torch.envs.cartpole import make_cartpole
    from safe_control_gym_torch.parallel import fast_cartpole as FC

    env = make_cartpole(cfg_cartpole(), device=dev)
    fr = FC.FastCartPoleRollout(env, B_MAIN, CP_FAST_STEPS, device=dev)
    return serve(dev, "config 2", env, fr, fr.prepare_action(0.0), FC.cartpole_rollout,
                 FC.cartpole_rollout_plain, "cartpole_rollout", "k5", K5_LAYOUT, 12)


def phase_serve_quad2d(dev):
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    env = make_quadrotor(cfg_quad2d(), device=dev)
    fr = PQ.FastPlanarQuadRollout(env, B_MAIN, Q2_FAST_STEPS, device=dev)
    act = fr.prepare_action(np.full(2, float(env.u_goal[0]), np.float32))
    return serve(dev, "config 3", env, fr, act, PQ.planar_rollout, PQ.planar_rollout_plain,
                 "quad_planar_rollout", "k7", k7_layout(6), 6 + 7)


def run_train(dev, tag, env, key, kernel, plain, kname, layout, nx, nu, hidden=HIDDEN,
              steps=TRAIN_STEPS, warmup=2):
    """A training path: ``steps`` timed PPO train steps after ``warmup``
    ones at the rl_train shapes (hidden width ``hidden``), the policy kernel
    (K3, K6 or K8; its observation instance where the env's observation is
    more than its ``nx`` state rows) once and K4 forty times per train
    step."""
    import torch

    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.parallel import fast_policy as P

    ppo = PPO(env, seed=0, rollout_batch_size=TRAIN_B, rollout_steps=TRAIN_T, opt_epochs=EPOCHS,
              mini_batch_size=MB, hidden_dim=hidden, use_fast_rollout=True,
              reshuffle_each_epoch=False)
    check(f"{tag}: PPO on the card takes {kname} and K4", ppo._fp is not None and ppo._fu is not None,
          f"{type(ppo._fp).__name__}, hidden {hidden}, obs {ppo.obs_dim}, "
          "use_fast_update='auto' on CUDA")
    obs = P.obs_ext(ppo._fp.params, nx) is not None
    D = ppo._fp.obs_dim
    res = {"obs_dim": D, "train_steps": steps}
    t0 = time.perf_counter()
    for _ in range(warmup):
        ppo.state, _ = ppo._train_step(ppo.state)
    torch.cuda.synchronize()
    res["warmup_s"] = time.perf_counter() - t0
    # The first timed call's own policy-kernel input: rows, packed weights,
    # and the seed the controller's generator is about to draw.
    fp, ac = ppo._fp, ppo.state.ac
    rows_in = ppo.state.env_state.clone()
    w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
    gen = torch.Generator(device=dev)
    gen.set_state(ppo.gen.get_state())
    seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    ppo.state, metrics = ppo.train_many(steps)(ppo.state)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    res["launches"] = read_counters()
    res["policy_launches"], res["k4_launches"] = res["launches"][key], res["launches"]["k4"]
    res["obs_launches"] = res["launches"].get(f"{key}_obs", 0)
    others = sum(v for k, v in res["launches"].items() if not k.startswith(key) and k != "k4")
    res["train_step_s"] = t_train / steps
    res["train_env_steps_s"] = steps * TRAIN_B * TRAIN_T / t_train
    res["train_metrics"] = {k: float(v) for k, v in metrics.items()}
    inst = "observation instance" if obs else "state-observation instance"
    check(f"{tag}: train steps went through the kernels",
          res["policy_launches"] == steps and res["obs_launches"] == (steps if obs else 0)
          and others == 0 and res["k4_launches"] == steps * EPOCHS * N_MINI,
          f"{kname} {res['policy_launches']} ({inst}; observation instance "
          f"{res['obs_launches']}) and K4 {res['k4_launches']} launches in {steps} train steps "
          f"(want 1 and {EPOCHS * N_MINI} per step), {others} others")
    check(f"{tag}: train step output", all(np.isfinite(v) for v in res["train_metrics"].values())
          and ppo.state.total_steps == (warmup + steps) * TRAIN_B * TRAIN_T
          and tuple(ppo.state.obs.shape) == (TRAIN_B, D),
          f"finite metrics {res['train_metrics']}, total_steps {ppo.state.total_steps}, "
          f"obs {tuple(ppo.state.obs.shape)}")

    # -- where a train step's time goes: device busy share and the kernels,
    # from a session that saw both the policy kernel and K4.
    step = lambda: ppo._train_step(ppo.state)  # noqa: E731
    kern = train_profile(step, kname)
    busy = sum(t for t, _ in kern.values())
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    res["profile"] = {
        "wall_ms": wall, "device_ms": busy, "busy_share": busy / wall if wall else None,
        "policy_device_ms": sum(t for k, (t, _) in kern.items() if kname in k),
        "k4_device_ms": sum(t for k, (t, _) in kern.items() if "ppo_grads" in k),
        "kernel_launches": sum(n for _, n in kern.values()),
        "top": sorted(((k[:80], t, n) for k, (t, n) in kern.items()), key=lambda r: -r[1])[:10]}
    tp = res["profile"]
    check(f"{tag}: the train-step profile holds {kname} and K4",
          tp["policy_device_ms"] > 0 and tp["k4_device_ms"] > 0,
          f"{kname} {tp['policy_device_ms']:.3f} ms, K4 {tp['k4_device_ms']:.3f} ms of "
          f"{tp['device_ms']:.3f} ms busy")

    # -- the policy kernel against its plain version on the first timed
    # call's own input.
    rows, traj = kernel(fp.params, rows_in, w, seed)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rows_p, traj_p = plain(fp.params, rows_in, w, seed)
    end.record()
    torch.cuda.synchronize()
    res["plain_ms"] = start.elapsed_time(end)
    res["main_max_abs_err"], res["main_differ"] = check_record(
        f"{kname} vs plain on the training path ({tag}, B={TRAIN_B}, {TRAIN_T} steps)", rows,
        traj, rows_p, traj_p, rows_in, layout, D, nu)
    res["resets"] = float(rows[layout["done"]].sum() - rows_in[layout["done"]].sum())
    res["truncations"] = float(traj[:, D + nu + 2].sum())

    # -- the policy kernel alone (K4 is timed in phase_k4).
    res["ms"] = device_ms(lambda: kernel(fp.params, rows_in, w, seed), 5)
    return res


def phase_train(dev):
    """The training paths: config 4 (K3), config 4-GH (K3's observation
    instance), cartpole_stab (K6), quad2d_stab (K8) at the rl_train width,
    quad2d_stab with goal rows and noise (K8's observation instance) and
    cartpole_stab with noise (K6's), and config 4 at hidden width 128 (K3's
    run-time-width instance and K4's wide plan)."""
    from safe_control_gym_torch.envs.cartpole import make_cartpole
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_cartpole as FC
    from safe_control_gym_torch.parallel import fast_policy as P
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    return {
        "config4": run_train(dev, "config 4", make_quadrotor(cfg4(normalized_rl_action_space=True),
                                                             device=dev),
                             "k3", P.policy_rollout, P.policy_rollout_plain,
                             "quad3d_policy_rollout", K2_LAYOUT, 12, 4),
        # Config 4-GH: K3's observation instance (obs 36) and K4 at (36, 4, 64).
        "config4_gh": run_train(dev, "config 4-GH", make_quadrotor(cfg4_gh(), device=dev),
                                "k3", P.policy_rollout, P.policy_rollout_plain,
                                "quad3d_policy_rollout", K2_LAYOUT, 12, 4),
        # The quad-2D family with goal rows and CartPole with the noise: the
        # observation instances of K8 and K6, one timed train step each.
        "quad2d_gh": run_train(dev, "quad2d_stab, h=2, noise", make_quadrotor(cfg_quad2d_gh(),
                                                                              device=dev),
                               "k8", PQ.planar_policy_rollout, PQ.planar_policy_rollout_plain,
                               "quad_planar_policy_rollout", k7_layout(6), 6, 2, steps=1,
                               warmup=1),
        "cartpole_noise": run_train(dev, "cartpole_stab, noise", make_cartpole(
            cfg_cartpole_rl(disturbances=OBS_NOISE), device=dev), "k6",
            FC.cartpole_policy_rollout, FC.cartpole_policy_rollout_plain,
            "cartpole_policy_rollout", K5_LAYOUT, 4, 1, steps=1, warmup=1),
        "cartpole": run_train(dev, "cartpole_stab", make_cartpole(cfg_cartpole_rl(), device=dev),
                              "k6", FC.cartpole_policy_rollout, FC.cartpole_policy_rollout_plain,
                              "cartpole_policy_rollout", K5_LAYOUT, 4, 1),
        "quad2d": run_train(dev, "quad2d_stab", make_quadrotor(cfg_quad2d_rl(), device=dev),
                            "k8", PQ.planar_policy_rollout, PQ.planar_policy_rollout_plain,
                            "quad_planar_policy_rollout", k7_layout(6), 6, 2),
        "config4_h128": run_train(dev, "config 4, H=128",
                                  make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev),
                                  "k3", P.policy_rollout, P.policy_rollout_plain,
                                  "quad3d_policy_rollout", K2_LAYOUT, 12, 4, hidden=128),
    }


def k1_bound(B, n_sub, actuation=True):
    """K1's least time at B envs and n_sub RK4 substeps, with the actuation
    or without (the thrust rows taken as motor forces): its rows read and
    written once, the substeps' and the four motors' operations."""
    motors = (4 * ACTUATE_OPS + 4 * ACTUATE_TRANS) if actuation else 0
    return bound(B * (12 + 4 + 3 + 1 + 3 + 12) * 4,
                 B * (n_sub * RK4_SUBSTEP_OPS + 1 + n_sub * 4 * FC_TRANS + motors))


def k4_bound(nx, nu, h, n):
    """K4's least time for one minibatch of n samples: the minibatch read
    once, the weights read and the gradients and loss sums written once,
    and the operations of k4_ops_per_sample."""
    n_g = 2 * (h * nx + h + h * h + h) + (nu + 1) * h + nu + 1 + nu
    return bound(4 * ((nx + nu + 4) * n + 2 * n_g + 3), n * k4_ops_per_sample(nx, nu, h))


def bound(nbytes, ops, peak_ops_s=PEAK_F32_OPS_S):
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops_s * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def policy_ops(nx, nu, hidden=HIDDEN):
    """Per env-step operations of a policy kernel beyond its env step at
    hidden width ``hidden``: the two nets' products and biases, the tanh of
    both hidden layers, the Philox blocks of the sample, Box-Muller,
    log-prob and the action map."""
    blocks = (2 * nu + 3) // 4
    return (k3_mlp_ops(hidden, nx, nu) + K3_MLP_TRANS_PER_H * hidden + blocks * K3_RNG_OPS // 2
            + nu * (K68_SAMPLE_OPS + K68_SAMPLE_TRANS))


def bounds(res, serve_cp, serve_q2, serve_mz, train, k3_maze):
    """Least time the card could take for each kernel's main-path work."""
    B = B_MAIN
    k1_bytes = B * (12 + 4 + 3 + 1 + 3 + 12) * 4
    k1_ops = B * (4 * RK4_SUBSTEP_OPS + 4 * ACTUATE_OPS + 1
                  + 4 * 4 * FC_TRANS + 4 * ACTUATE_TRANS)
    k2_bytes = B * (2 * 27 + 4) * 4
    env_steps = B * FAST_STEPS
    k2_step = 4 * RK4_SUBSTEP_OPS + 4 * 4 * FC_TRANS + K2_STEP_OPS + K2_STEP_TRANS
    k2_ops = (env_steps * k2_step + res["fast_resets"] * K2_RESET_OPS
              + B * 4 * (ACTUATE_OPS + ACTUATE_TRANS))
    # The policy kernels at the training paths' shapes: rows in and out, the
    # packed weights read once, the record written once; the env step plus
    # the policy per env-step, the resets of this run's timed call.
    steps_t = TRAIN_B * TRAIN_T

    def policy_bytes(n_rows, nx, nu, hidden=HIDDEN):
        h2 = 2 * hidden
        n_w = h2 * nx + h2 + h2 * h2 + h2 + 8 * h2 + 8 + nu
        return 4 * (TRAIN_B * 2 * n_rows + n_w + TRAIN_T * (2 * nx + nu + 5) * TRAIN_B)

    def obs_ops(tag, nx, goal_ops):
        """An observation instance's own work on training path ``tag``: the
        policy's observation every step (noised state rows, goal blocks),
        the terminal one on this run's truncated steps only."""
        tr = train[tag]
        per = nx * OBS_NOISE_ROW_OPS + (tr["obs_dim"] // nx - 1) * goal_ops
        return (steps_t + tr["truncations"]) * per

    def k3_ops(tag, hidden):
        return (steps_t * (k2_step + policy_ops(12, 4, hidden) + K3_ACTION_OPS)
                + train[tag]["resets"] * K2_RESET_OPS)
    # K5: config 2, one RK4 substep, the action noise, constant force.
    k5_step = CP_SUBSTEP_OPS + 4 * CP_FC_TRANS + K5_STEP_OPS + K5_STEP_TRANS
    k5_ops = B * CP_FAST_STEPS * (k5_step + K5_NOISE_OPS + K5_NOISE_TRANS) \
        + serve_cp["resets"] * K5_RESET_OPS
    k6_ops = steps_t * (k5_step + policy_ops(4, 1)) + train["cartpole"]["resets"] * K5_RESET_OPS
    # K7: config 3, 2D, four RK4 substeps.
    k7_step = 4 * (Q2_SUBSTEP_OPS + 4 * Q2_FC_TRANS) + K7_STEP_OPS + K7_STEP_TRANS
    k7_ops = B * Q2_FAST_STEPS * k7_step + serve_q2["resets"] * K7_RESET_OPS
    k8_ops = steps_t * (k7_step + policy_ops(6, 2)) + train["quad2d"]["resets"] * K7_RESET_OPS
    # K2's maze instance on config 5's serving call: 55 rows in and out, two
    # RK4 substeps a step, the maze and the noise, this run's resets, and
    # the gates' sincos at the call's start.
    k2_maze_ops = (env_steps * (2 * (RK4_SUBSTEP_OPS + 4 * FC_TRANS) + MAZE_STEP_OPS
                                + MAZE_STEP_TRANS)
                   + serve_mz["resets"] * K2_MAZE_RESET_OPS + B * 4)
    # K3's maze instance on its main path (config 5, B = 4096, T = 128): K2's
    # maze step with the noise, the policy (products, sample, action map and
    # cost), this call's resets, the gates' sincos at the call's start; the
    # rows (27 + 28 maze rows) in and out, the weights, the record.
    def k3_maze_bound(h):
        step = (2 * (RK4_SUBSTEP_OPS + 4 * FC_TRANS) + MAZE_STEP_OPS + MAZE_STEP_TRANS
                + policy_ops(12, 4, h) + 16)
        ops = steps_t * step + k3_maze[str(h)]["resets"] * K2_MAZE_RESET_OPS + TRAIN_B * 4
        return bound(policy_bytes(55, 12, 4, h), ops)

    out = {"k1": bound(k1_bytes, k1_ops), "k1_f64": bound(2 * k1_bytes, k1_ops, PEAK_F64_OPS_S),
           "k3_maze": k3_maze_bound(HIDDEN), "k3_maze_h128": k3_maze_bound(128),
           "k2": bound(k2_bytes, k2_ops), "k2_maze": bound(B * (2 * 55 + 4) * 4, k2_maze_ops),
           "k3": bound(policy_bytes(27, 12, 4), k3_ops("config4", HIDDEN)),
           "k3_h128": bound(policy_bytes(27, 12, 4, 128), k3_ops("config4_h128", 128)),
           "k5": bound(B * (2 * 18 + 1) * 4, k5_ops), "k6": bound(policy_bytes(18, 4, 1), k6_ops),
           "k7": bound(B * (2 * 19 + 2) * 4, k7_ops), "k8": bound(policy_bytes(19, 6, 2), k8_ops),
           # The observation instances on their training paths: the first
           # layer over the D observation rows (policy_ops), the noise and
           # goal rows (obs_ops), the record of 2 D + nu + 5 rows.
           "k3_obs": bound(policy_bytes(27, 36, 4), steps_t * (k2_step + policy_ops(36, 4)
                                                                + K3_ACTION_OPS)
                           + obs_ops("config4_gh", 12, GOAL3_OPS)
                           + train["config4_gh"]["resets"] * K2_RESET_OPS),
           "k8_obs": bound(policy_bytes(19, 12, 2), steps_t * (k7_step + policy_ops(12, 2))
                           + obs_ops("quad2d_gh", 6, 0)
                           + train["quad2d_gh"]["resets"] * K7_RESET_OPS),
           "k6_obs": bound(policy_bytes(18, 4, 1), steps_t * (k5_step + policy_ops(4, 1))
                           + obs_ops("cartpole_noise", 4, 0)
                           + train["cartpole_noise"]["resets"] * K5_RESET_OPS)}
    # K4 per launch at each of its shapes: the minibatch read once, the
    # weights read and the gradients and loss sums written once.
    for tag, (nx, nu, h, _) in K4_SHAPES.items():
        out[f"k4_{tag}"] = k4_bound(nx, nu, h, MB)
    return out


def policy_instance(ptxas, kname, quad, plan):
    """The group, block, registers and spill bytes of the policy kernel's
    instance that the training path launches (``quad``: the mangled quad
    type of K8's, "Li6ELi2E" for the 2D quad; H = 64) under ``plan``."""
    group, block = plan[:2]
    name = next(n for n in ptxas if f"{kname}I{quad}Li{HIDDEN}ELi{group}E" in n)
    r = ptxas[name]
    return {"group": group, "block": block, "registers": r["registers"],
            "spill_bytes": r["spill_stores"] + r["spill_loads"]}


def obs_instance(ptxas, kname, quad="", tail=""):
    """Registers and spill bytes of a policy kernel's observation instance
    (8 lanes an env, the width read at run time; ``quad`` as for
    policy_instance; ``tail`` K3's further template arguments, "Lb0E" for
    its instance without the maze)."""
    r = next(r for n, r in ptxas.items() if f"{kname}I{quad}Li0ELi8ELb1E{tail}" in n)
    return {"group": 8, "registers": r["registers"],
            "spill_bytes": r["spill_stores"] + r["spill_loads"]}


def k3_maze_instances(ptxas):
    """Registers and spill bytes of K3's three maze instances: H = 64, the
    run-time width, and the observation instance."""
    out = {}
    for tag, args in (("H=64", "Li64ELi8ELb0E"), ("run-time width", "Li0ELi8ELb0E"),
                      ("observation", "Li0ELi8ELb1E")):
        r = next(r for n, r in ptxas.items() if f"quad3d_policy_rollout_kernelI{args}Lb1E" in n)
        out[tag] = {"registers": r["registers"],
                    "spill_bytes": r["spill_stores"] + r["spill_loads"]}
    return out


def k1_instances(ptxas):
    """Registers and spill bytes of each K1 instance, by scalar type and
    group ("float32 G=4")."""
    from safe_control_gym_torch.ops import quad_substeps as K1

    out = {}
    for t, name in (("f", "float32"), ("d", "float64")):
        for g in K1.GROUPS:
            r = next(r for n, r in ptxas.items() if f"quad3d_substeps_kernelI{t}Li{g}E" in n)
            out[f"{name} G={g}"] = {"registers": r["registers"],
                                   "spill_bytes": r["spill_stores"] + r["spill_loads"]}
    return out


def k2_instance(ptxas, maze):
    """Registers and spill bytes of K2's instance for config 4 (``maze``
    False) or its maze instance."""
    r = next(r for n, r in ptxas.items() if f"quad3d_rollout_kernelILi4ELb{int(maze)}E" in n)
    return {"registers": r["registers"], "spill_bytes": r["spill_stores"] + r["spill_loads"]}


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd, **extra):
    return {"name": name, "route": "cuda", "source": f"safe_control_gym_torch/csrc/{source}",
            "replaces": f"safe_control_gym_tpu/{replaces}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
            "bound_by": bnd["bound_by"], "library_ms": None, **extra}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    phase_s = {}

    def phase(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[fn.__name__] = time.perf_counter() - t0
        print(f"[phase] {fn.__name__}: {phase_s[fn.__name__]:.1f} s", flush=True)
        return out

    build_s, ptxas = phase(phase_build)
    k1_errs, k1_inputs = phase(phase_k1, dev)
    k1_f64 = phase(phase_k1_float64, dev, k1_inputs)
    nat = phase(phase_native, dev)
    k2_err, env_c, fr_c, rows0, rows_k2 = phase(phase_k2, dev)
    cross_err = phase(phase_cross, dev, env_c, fr_c, rows0, rows_k2)
    maze_err = phase(phase_k2_maze, dev)
    maze_cross_err = phase(phase_maze_cross, dev)
    res = phase(phase_main, dev)
    k3_err, k3_differ = phase(phase_k3, dev)
    k3_maze = phase(phase_k3_maze, dev)
    surface = phase(phase_env_surface, dev)
    k4 = phase(phase_k4, dev)
    small = {**phase(phase_k5_k6, dev), **phase(phase_k7_k8, dev), **phase(phase_obs_ext, dev)}
    serve_cp = phase(phase_serve_cartpole, dev)
    serve_q2 = phase(phase_serve_quad2d, dev)
    serve_mz = phase(phase_serve_maze, dev)
    train = phase(phase_train, dev)
    lqr = phase(phase_lqr, dev)
    pid = phase(phase_pid, dev)
    ppo_extras = phase(phase_ppo_extras, dev)
    mpc_solve = phase(phase_mpc_solve, dev)
    mpc = phase(phase_mpc, dev)
    ilqr = phase(phase_ilqr, dev)
    linear_mpc = phase(phase_linear_mpc, dev)
    gp_mpc = phase(phase_gp_mpc, dev)
    cbf = phase(phase_cbf, dev)
    firmware = phase(phase_firmware, dev)
    comp_sim = phase(phase_competition_sim_only, dev)
    comp = phase(phase_competition, dev)
    learners = phase(phase_learners, dev)
    s2r = phase(phase_sim2real, dev)
    experiment = phase(phase_experiment, dev)
    dist_res = phase(phase_distributed, dev)
    bnd = bounds(res, serve_cp, serve_q2, serve_mz, train, k3_maze)
    bnd["k1_b1"] = k1_bound(1, 1)
    bnd["k1_b4"] = k1_bound(4, learners["sac"]["k1"]["n_sub"])
    bnd["k1_fit"] = k1_bound(FIT_CANDIDATES, 1, actuation=False)
    bnd["k4_mb64"] = k4_bound(12, 4, HIDDEN, learners["safe_explorer"]["k4"]["mb"])

    from safe_control_gym_torch.ops import quad_substeps as K1
    from safe_control_gym_torch.parallel import fast_cartpole as FC
    from safe_control_gym_torch.parallel import fast_env as F
    from safe_control_gym_torch.parallel import fast_policy as P
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    print(f"general engine: {res['general_env_steps_s']:.6g} env-steps/s "
          f"(B={B_MAIN}, {GENERAL_STEPS} steps in {res['general_s']:.4f} s)")
    print(f"whole-rollout engine: {res['fast_env_steps_s']:.6g} env-steps/s "
          f"(B={B_MAIN}, {FAST_STEPS} steps in {res['fast_call_ms']:.4f} ms)")
    k1_plan = {d: K1.launch_plan(B_MAIN, getattr(torch, d)) for d in ("float32", "float64")}
    print(f"K1 device time {res['k1_ms'] * 1e3:.4f} us per launch, plan (group, block, grid) "
          f"{k1_plan['float32']} (bound {bnd['k1']['bound_ms'] * 1e3:.4f} us); back-to-back "
          f"from Python {res['k1_launch_ms'] * 1e3:.4f} us per launch")
    print(f"K2 device time {res['k2_ms']:.4f} ms per call of {FAST_STEPS} steps, {F.GROUP} lanes "
          f"per env, blocks of {F.BLOCK} (bound {bnd['k2']['bound_ms']:.4f} ms); "
          f"{res['fast_resets']:.0f} auto-resets per call")
    gp = res["general_profile"]
    print(f"general engine, 32 steps: wall {gp['wall_ms']:.3f} ms, device busy "
          f"{gp['device_ms']:.3f} ms ({gp['busy_share']}), {gp['kernel_launches']} "
          f"kernel launches; K1 {gp['k1_device_ms']:.4f} ms of the device time "
          f"({gp['k1_device_share']}); top {gp['top']}")
    print(f"K1 float64 device time {k1_f64['ms'] * 1e3:.4f} us per launch, plan "
          f"{k1_plan['float64']} (bound "
          f"{bnd['k1_f64']['bound_ms'] * 1e3:.4f} us, {bnd['k1_f64']['bound_by']}); plain "
          f"{k1_f64['plain_ms']:.4f} ms per call")
    print(f"launch counters: K1 {res['k1_launches']}, K2 {res['k2_launches']}")
    print(f"plain versions (no yardstick): K1 {res['k1_plain_ms']:.4f} ms per call, "
          f"K2 {res['k2_plain_ms']:.1f} ms per call of {PLAIN_STEPS} steps")
    for tag, sv, kn, steps, b in (("config 5", serve_mz, "K2 maze instance", FAST_STEPS,
                                   bnd["k2_maze"]),
                                  ("config 2", serve_cp, "K5", CP_FAST_STEPS, bnd["k5"]),
                                  ("config 3", serve_q2, "K7", Q2_FAST_STEPS, bnd["k7"])):
        print(f"{tag}: general engine {sv['general_env_steps_s']:.6g} env-steps/s "
              f"({SERVE_GENERAL_STEPS} steps); whole-rollout {sv['fast_env_steps_s']:.6g} "
              f"env-steps/s (B={B_MAIN}, {steps} steps in {sv['fast_call_ms']:.4f} ms); {kn} device "
              f"time {sv['ms']:.4f} ms (bound {b['bound_ms']:.4f} ms, {b['bound_by']}); "
              f"{sv['resets']:.0f} auto-resets; plain {sv['plain_ms']:.1f} ms per "
              f"{sv['plain_steps']} steps; {card_line()}")
    for tag, pk in (("config4", "K3"), ("config4_gh", "K3 obs"), ("cartpole", "K6"),
                    ("cartpole_noise", "K6 obs"), ("quad2d", "K8"), ("quad2d_gh", "K8 obs"),
                    ("config4_h128", "K3")):
        tr, tp = train[tag], train[tag]["profile"]
        print(f"PPO train step {tag} (B={TRAIN_B}, T={TRAIN_T}, obs {tr['obs_dim']}, {EPOCHS} "
              f"epochs x {N_MINI} minibatches of {MB}): {tr['train_env_steps_s']:.6g} env-steps/s, "
              f"{tr['train_step_s'] * 1e3:.3f} ms per train step over {tr['train_steps']}; metrics "
              f"{tr['train_metrics']}; launches per train step: {pk} "
              f"{tr['policy_launches'] / tr['train_steps']:g}, "
              f"K4 {tr['k4_launches'] / tr['train_steps']:g}")
        print(f"  train step: wall {tp['wall_ms']:.3f} ms, device busy {tp['device_ms']:.3f} ms "
              f"({tp['busy_share']}), {pk} {tp['policy_device_ms']:.3f} ms, K4 "
              f"{tp['k4_device_ms']:.3f} ms, {tp['kernel_launches']} kernel launches; top {tp['top']}")
        pb = bnd[{"config4": "k3", "cartpole": "k6", "quad2d": "k8", "config4_h128": "k3_h128",
                  "config4_gh": "k3_obs", "cartpole_noise": "k6_obs", "quad2d_gh": "k8_obs"}[tag]]
        print(f"  {pk} device time {tr['ms']:.4f} ms per call of {TRAIN_T} steps (bound "
              f"{pb['bound_ms']:.4f} ms, {pb['bound_by']}, {pb['bound_ms'] / tr['ms']:.1%} of it); "
              f"plain {tr['plain_ms']:.1f} ms; {tr['resets']:.0f} auto-resets, "
              f"{tr['truncations']:.0f} truncations; warm-up {tr['warmup_s']:.1f} s")
    for tag, kr in k4.items():
        kb = bnd[f"k4_{tag}"]
        print(f"K4 {tag} (nx {kr['nx']}, nu {kr['nu']}, H {kr['H']}, mb={MB}): "
              f"{kr['ms'] * 1e3:.2f} us per launch, bound {kb['bound_ms'] * 1e3:.2f} us "
              f"({kb['bound_by']}), {kb['bound_ms'] / kr['ms']:.1%} of it; plain "
              f"{kr['plain_ms'] * 1e3:.2f} us; plan {kr['plan']}")

    k3_sass = {tag: sass_instructions(name) for tag, name in K3_SASS.items()}
    print(f"K3 SASS instructions: {k3_sass} (config 4's at H = 64: 4856 before the maze instances)")
    for h, b in ((HIDDEN, "k3_maze"), (128, "k3_maze_h128")):
        km, kb = k3_maze[str(h)], bnd[b]
        print(f"K3 maze instance, config 5 (B={B_MAIN}, T={TRAIN_T}, H={h}): {km['ms']:.4f} ms per "
              f"call (bound {kb['bound_ms']:.4f} ms, {kb['bound_by']}, "
              f"{kb['bound_ms'] / km['ms']:.1%} of it); plain {km['plain_ms']:.1f} ms; "
              f"{km['resets']:.0f} auto-resets, {km['truncations']:.0f} truncations; {card_line()}")

    c4 = train["config4"]
    # K3 at both widths the training paths run: H = 64 (the entry's own
    # numbers) and H = 128 (the run-time-width instance).
    k3_by_width = {str(h): {"launches": train[tag]["policy_launches"], "ms": train[tag]["ms"],
                            "plain_ms": train[tag]["plain_ms"], "bound_ms": bnd[b]["bound_ms"],
                            "bound_by": bnd[b]["bound_by"],
                            "max_abs_err": train[tag]["main_max_abs_err"]}
                   for h, tag, b in ((HIDDEN, "config4", "k3"), (128, "config4_h128", "k3_h128"))}
    k4_by_path = {tag: {**k4[tag], "launches": train.get(tag, {}).get("k4_launches", 0),
                        "bound_ms": bnd[f"k4_{tag}"]["bound_ms"],
                        "bound_by": bnd[f"k4_{tag}"]["bound_by"]}
                  for tag in K4_SHAPES}
    # SafeExplorerPPO's update (config 4, mb = 64): device ms a call (its
    # two or three kernels), launch floor, against the plain version.
    k4_by_path["safe_explorer_mb64"] = {**learners["safe_explorer"]["k4"],
                                        "bound_ms": bnd["k4_mb64"]["bound_ms"],
                                        "bound_by": bnd["k4_mb64"]["bound_by"]}

    def k1_at(r, b):  # K1 on a learner's or the fit's own inputs
        return {k: r["k1"][k] for k in ("batch", "samples", "max_abs_err", "ms",
                                        "empty_kernel_ms", "plain_ms", "n_sub", "actuation")} | {
            "group": r["k1"]["plan"][0], "block": r["k1"]["plan"][1],
            "bound_ms": bnd[b]["bound_ms"], "bound_by": bnd[b]["bound_by"]}

    learner_k1 = {
        **{f"{tag}_config4": {"launches": learners[tag]["launches"]["k1"],
                              "train_steps": learners[tag]["train_steps"],
                              "host_ms_per_train_step": learners[tag]["host_ms_per_train_step"],
                              **k1_at(learners[tag], "k1_b4")} for tag in ("sac", "ddpg")},
        **{f"{tag}_config4": {"batch": 4, "launches": learners[tag]["launches"]["k1"],
                              "cycles": 1, "host_ms_per_cycle": learners[tag]["host_ms_per_cycle"]}
           for tag in ("rarl", "rap")},
        "safe_explorer_config4": {"batch": 4, "train_steps": 1,
                                  "launches": learners["safe_explorer"]["launches"]["k1"],
                                  "host_ms_per_train_step":
                                      learners["safe_explorer"]["host_ms_per_train_step"]},
        "sim2real_fit": {"launches": s2r["launches"]["k1"], "fit_ms": s2r["fit_ms"],
                         **k1_at(s2r, "k1_fit")}}
    kernels_line = {"kernels": [
        kernel_entry("quad3d_substeps", "quad3d_substeps.cu", "ops/pallas_quad.py:109",
                     res["k1_launches"], max(*k1_errs.values(), res["k1_main_max_abs_err"],
                                             learners["sac"]["k1"]["max_abs_err"],
                                             learners["ddpg"]["k1"]["max_abs_err"],
                                             s2r["k1"]["max_abs_err"]),
                     res["k1_ms"], res["k1_plain_ms"], bnd["k1"], group=k1_plan["float32"][0],
                     block=k1_plan["float32"][1], instances=k1_instances(ptxas),
                     float64={**k1_f64, **bnd["k1_f64"], "group": k1_plan["float64"][0],
                              "block": k1_plan["float64"][1]},
                     # The general engine under the LQR and the PID (B = 4096):
                     # launches over one episode, profiled device ms a launch.
                     on_paths={tag: {"launches": r["launches"]["k1"], "steps": r["steps"],
                                     "ms": r["profile"]["k1_ms_per_launch"],
                                     "host_ms_per_step": r["host_ms_per_step"]}
                               for tag, r in (("lqr_tracking_config4", lqr),
                                              ("pid_quad3d", pid))}
                     | {"mpc_quad3d": {"launches": mpc["launches"]["k1"], "steps": mpc["steps"],
                                       "ms": mpc["k1_ms_per_launch"],
                                       "host_ms_per_step": mpc["host_ms_per_step"]}}
                     # The competition: one drone (B = 1, one substep) a
                     # firmware tick (level 2, default stack) and a
                     # sim-only step (level 0).
                     | {"competition_level2_firmware": {
                         "batch": 1, "launches": comp["k1_b1"]["launches"],
                         "ticks": comp["ticks"], "control_steps": comp["steps"],
                         "ms": comp["k1_b1"]["ms"], "empty_kernel_ms": comp["k1_b1"]["empty_kernel_ms"],
                         "plain_ms": comp["k1_b1"]["plain_ms"],
                         "bound_ms": bnd["k1_b1"]["bound_ms"], "bound_by": bnd["k1_b1"]["bound_by"],
                         "max_abs_err": comp["k1_b1"]["max_abs_err"], "group": comp["k1_b1"]["plan"][0],
                         "block": comp["k1_b1"]["plan"][1]},
                        "competition_level0_sim_only": {"batch": 1, "launches": comp_sim["launches"]["k1"],
                                                        "steps": comp_sim["steps"]}}
                     # The float64 3D env held against the native C++
                     # oracle (phase_native): K1's float64 instance a step.
                     | {"native_oracle_float64": {
                         "batch": NATIVE_B, "launches": nat["launches"]["k1"],
                         "steps": NATIVE_STEPS, "host_ms_per_step": nat["card_ms_per_step"],
                         "max_abs_err_vs_oracle": nat["max_abs_err"],
                         "oracle_ms": nat["oracle_ms"]}}
                     | learner_k1
                     # The distributed path: (a) the one-rank NCCL group's
                     # rollout and train step, (b) the gloo ranks' dry run
                     # and worker, launches summed over the ranks.
                     | {"distributed": {"launches": dist_res["launches"]["k1"],
                                        "rollout_launches": dist_res["rollout"]["launches"]["k1"],
                                        "train_step_launches":
                                            dist_res["train_step"]["launches"]["k1"]}}),
        kernel_entry("quad3d_rollout", "quad3d_rollout.cu", "parallel/fast_env.py:593",
                     res["k2_launches"], max(k2_err, res["k2_main_max_abs_err"]), res["k2_ms"],
                     res["k2_plain_ms"], bnd["k2"], plain_steps=PLAIN_STEPS,
                     max_abs_err_vs_general_engine=cross_err, group=F.GROUP, block=F.BLOCK,
                     **k2_instance(ptxas, False),
                     distributed={"launches": dist_res["launches"]["k2"], "ranks": DIST_RANKS,
                                  "envs_per_rank": dist_res["cluster"]["dryrun"]["k2"][
                                      "envs_per_rank"], "bit_equal": True},
                     maze={"config": 5, "launches": serve_mz["launches"]["k2"],
                           "max_abs_err": max(maze_err, serve_mz["main_max_abs_err"]),
                           "max_abs_err_vs_general_engine": maze_cross_err, "ms": serve_mz["ms"],
                           "plain_ms": serve_mz["plain_ms"], "plain_steps": MAZE_PLAIN_STEPS,
                           "bound_ms": bnd["k2_maze"]["bound_ms"],
                           "bound_by": bnd["k2_maze"]["bound_by"],
                           "env_steps_s": serve_mz["fast_env_steps_s"],
                           **k2_instance(ptxas, True)}),
        kernel_entry("quad3d_policy_rollout", "quad3d_policy_rollout.cu",
                     "parallel/fast_policy.py:76", c4["policy_launches"],
                     max(k3_err, c4["main_max_abs_err"]), c4["ms"], c4["plain_ms"], bnd["k3"],
                     share_not_bit_equal=max(k3_differ, c4["main_differ"]), group=P.GROUP,
                     block=P.BLOCK, by_width=k3_by_width),
        kernel_entry("ppo_grads", "ppo_update.cu", "parallel/fast_update.py:44",
                     c4["k4_launches"], max(k4["config4"]["max_abs_err"],
                                            learners["safe_explorer"]["k4"]["max_abs_err"]),
                     k4["config4"]["ms"],
                     k4["config4"]["plain_ms"], bnd["k4_config4"],
                     max_abs_err_vs_autograd=k4["config4"]["max_abs_err_vs_autograd"],
                     by_path=k4_by_path,
                     distributed={"launches": dist_res["launches"]["k4"],
                                  "train_step_launches": dist_res["train_step"]["launches"]["k4"],
                                  "max_abs_err_allreduced": dist_res["cluster"]["dryrun"]["k4"][
                                      "max_abs_err"]}),
        kernel_entry("cartpole_rollout", "cartpole_rollout.cu", "parallel/fast_cartpole.py:264",
                     serve_cp["launches"]["k5"], max(small["k5_err"], serve_cp["main_max_abs_err"]),
                     serve_cp["ms"], serve_cp["plain_ms"], bnd["k5"], plain_steps=PLAIN_STEPS,
                     max_abs_err_vs_general_engine=small["k5_cross_err"],
                     group=FC.launch_plan(B_MAIN)[0], block=FC.launch_plan(B_MAIN)[1]),
        kernel_entry("cartpole_policy_rollout", "cartpole_policy_rollout.cu",
                     "parallel/fast_cartpole.py:288", train["cartpole"]["policy_launches"],
                     max(small["k6_err"], train["cartpole"]["main_max_abs_err"]),
                     train["cartpole"]["ms"], train["cartpole"]["plain_ms"], bnd["k6"],
                     share_not_bit_equal=max(small["k6_differ"], train["cartpole"]["main_differ"]),
                     **policy_instance(ptxas, "cartpole_policy_rollout_kernel", "",
                                       FC.policy_launch_plan(TRAIN_B, HIDDEN))),
        kernel_entry("quad_planar_rollout", "quad_planar_rollout.cu",
                     "parallel/fast_quad_planar.py:339", serve_q2["launches"]["k7"],
                     max(small["k7_err"], serve_q2["main_max_abs_err"]), serve_q2["ms"],
                     serve_q2["plain_ms"], bnd["k7"], plain_steps=PLAIN_STEPS,
                     max_abs_err_vs_general_engine=small["k7_cross_err"],
                     group={"1D": PQ.launch_plan(B_MAIN, 2)[0], "2D": PQ.launch_plan(B_MAIN, 6)[0]},
                     block={"1D": PQ.launch_plan(B_MAIN, 2)[1], "2D": PQ.launch_plan(B_MAIN, 6)[1]}),
        kernel_entry("quad_planar_policy_rollout", "quad_planar_policy_rollout.cu",
                     "parallel/fast_quad_planar.py:677", train["quad2d"]["policy_launches"],
                     max(small["k8_err"], train["quad2d"]["main_max_abs_err"]),
                     train["quad2d"]["ms"], train["quad2d"]["plain_ms"], bnd["k8"],
                     share_not_bit_equal=max(small["k8_differ"], train["quad2d"]["main_differ"]),
                     **policy_instance(ptxas, "quad_planar_policy_rollout_kernel", "Li6ELi2E",
                                       PQ.policy_launch_plan(TRAIN_B, HIDDEN, 6))),
        # The observation instances, each on its training path.
        *[kernel_entry(f"{name}_obs", f"{name}.cu", replaces, train[tag]["obs_launches"],
                       max(small[f"{key}_obs_err"], train[tag]["main_max_abs_err"]),
                       train[tag]["ms"], train[tag]["plain_ms"], bnd[f"{key}_obs"],
                       share_not_bit_equal=max(small[f"{key}_obs_differ"],
                                               train[tag]["main_differ"]),
                       obs_dim=train[tag]["obs_dim"], path=tag,
                       **obs_instance(ptxas, f"{name}_kernel", quad,
                                      "Lb0E" if key == "k3" else ""))
          for name, replaces, tag, key, quad in (
              ("quad3d_policy_rollout", "parallel/fast_policy.py:76", "config4_gh", "k3", ""),
              ("cartpole_policy_rollout", "parallel/fast_cartpole.py:288", "cartpole_noise", "k6",
               ""),
              ("quad_planar_policy_rollout", "parallel/fast_quad_planar.py:677", "quad2d_gh", "k8",
               "Li6ELi2E"))],
        # K3's maze instances on config 5 (B = 4096, T = 128).
        kernel_entry("quad3d_policy_rollout_maze", "quad3d_policy_rollout.cu",
                     "parallel/fast_policy.py:76", k3_maze[str(HIDDEN)]["launches"]["k3_maze"],
                     k3_maze["max_abs_err"], k3_maze[str(HIDDEN)]["ms"],
                     k3_maze[str(HIDDEN)]["plain_ms"], bnd["k3_maze"], config=5,
                     max_abs_err_vs_general_engine=k3_maze["max_abs_err_vs_general_engine"],
                     resets=k3_maze[str(HIDDEN)]["resets"],
                     truncations=k3_maze[str(HIDDEN)]["truncations"], group=P.GROUP, block=P.BLOCK,
                     instances=k3_maze_instances(ptxas), sass=k3_sass,
                     by_width={"128": {"ms": k3_maze["128"]["ms"],
                                       "plain_ms": k3_maze["128"]["plain_ms"],
                                       "bound_ms": bnd["k3_maze_h128"]["bound_ms"],
                                       "bound_by": bnd["k3_maze_h128"]["bound_by"]}}),
    ]}
    for tag, r in (("LQR tracking, config 4", lqr), ("PID, 3D quad", pid)):
        pr = r["profile"]
        print(f"{tag} (B={B_MAIN}): {r['host_ms_per_step']:.3f} host ms a general-engine step, "
              f"K1 {r['launches']['k1']} launches in {r['steps']} steps, {pr['k1_ms_per_launch'] * 1e3:.4f} us a launch "
              f"(profiled {pr['steps']} steps: wall {pr['wall_ms']:.3f} ms, device busy "
              f"{pr['device_ms']:.3f} ms, {pr['kernel_launches']} kernel launches)")
    print(f"LQR: gain table card/CPU {lqr['gain_rel_err']:.3g}, float64 DARE/scipy "
          f"{lqr['dare_f64_rel_err']:.3g}, tracking RMSE median "
          f"{lqr['tracking_rmse_median']:.4g} m; CartPole run(analysis=True) state_rmse "
          f"{lqr['cartpole']['state_rmse']}")
    ms_ = mpc_solve
    print(f"MPC solve (2D quad, B={ms_['batch']}, H={ms_['horizon']}): {ms_['batched_ms']:.2f} ms a "
          f"batched solve, {ms_['single_ms']:.2f} ms a single solve, {ms_['launches_per_solve']} "
          f"launches and {ms_['device_ms_per_solve']:.3f} device ms a batched solve, no "
          f"host sync; MPC on the 3D quad (B={MPC_SOLVE_B}): {mpc['host_ms_per_step']:.2f} host "
          f"ms a step, K1 {mpc['launches']['k1']} launches in {mpc['steps']} steps, median final "
          f"position error {mpc['median_final_pos_err']:.4g} m")
    print(f"iLQR learn() {ilqr['learn_ms']:.1f} ms (backward pass {ilqr['backward_ms']:.2f} ms, "
          f"200 eigh {ilqr['eigh_200_ms']:.2f} ms); LinearMPC {linear_mpc['host_ms_per_step']:.2f} "
          f"host ms a step; GP-MPC learn() {gp_mpc['learn_ms']:.0f} ms, "
          f"{gp_mpc['host_ms_per_step']:.2f} ms a step; CBF certify {cbf['certify_ms']:.2f} ms "
          f"for {CBF_B} states")
    print(f"firmware: fused block {firmware['block_ms']:.2f} host ms, "
          f"{firmware['launches_per_block']} device operations ({firmware['ticks_per_block']} ticks), "
          f"fused/host max_abs_err {firmware['max_abs_err']:.3g} (bit-equal {firmware['bit_equal']}); "
          f"level 0 sim-only {comp_sim['steps']} steps at {comp_sim['steps_per_sec']:.4g} steps/s; "
          f"level 2 default stack {comp['steps']} control steps at {comp['steps_per_sec']:.4g} "
          f"steps/s (sim_speedup {comp['sim_speedup']:.4g}), block {comp['block_ms']:.2f} ms, "
          f"MPCC cold {comp['cold_solve_ms']:.1f} / warm {comp['warm_solve_ms']:.1f} ms, K1 B=1 "
          f"{comp['k1_b1']['ms'] * 1e3:.4f} us (bound {bnd['k1_b1']['bound_ms'] * 1e3:.6f} us, "
          f"empty kernel {comp['k1_b1']['empty_kernel_ms'] * 1e3:.4f} us); {card_line()}")
    print(f"PPO extras: fused/separate update max_abs_err {ppo_extras['max_abs_err']:.3g}; CNN "
          f"{ppo_extras['cnn_max_abs_err']:.3g}, RNN {ppo_extras['rnn_max_abs_err']:.3g}, "
          f"Categorical {ppo_extras['categorical_max_abs_err']:.3g} against the CPU")
    for tag in ("sac", "ddpg"):
        r, kb = learners[tag], bnd["k1_b4"]
        print(f"{tag.upper()} on config 4 (B=4, H=256): {r['host_ms_per_train_step']:.2f} host "
              f"ms a train step of {r['env_steps_per_train_step']} env steps, "
              f"{r['device_ops_per_train_step']} device operations, busy {r['busy_share']:.1%}; "
              f"K1 {r['launches']['k1']} launches in {r['train_steps']} train steps, "
              f"{r['k1']['ms'] * 1e3:.4f} us a launch at B=4 (bound {kb['bound_ms'] * 1e3:.6f} us, "
              f"{kb['bound_by']}; empty kernel {r['k1']['empty_kernel_ms'] * 1e3:.4f} us)")
    se, lg = learners["safe_explorer"], learners["learning_gate"]
    print(f"RARL {learners['rarl']['host_ms_per_cycle']:.1f} / RAP "
          f"{learners['rap']['host_ms_per_cycle']:.1f} host ms a cycle (K1 "
          f"{learners['rarl']['launches']['k1']} / {learners['rap']['launches']['k1']}); "
          f"SafeExplorerPPO pretrain {se['pretrain_ms']:.1f} ms, train step "
          f"{se['host_ms_per_train_step']:.1f} ms, K4 {se['k4']['launches']} launches at mb=64, "
          f"{se['k4']['ms'] * 1e3:.3f} us a call (bound {bnd['k4_mb64']['bound_ms'] * 1e3:.4f} us, "
          f"floor {se['k4']['empty_kernel_ms'] * 1e3:.3f} us); SAC learning gate r0 "
          f"{lg['r0']:.4g} -> r1 {lg['r1']:.4g} ({lg['wall_s']:.1f} s)")
    print(f"sim2real fit: {s2r['fit_ms']:.3f} ms ({FIT_CANDIDATES} candidates, {FIT_T} steps), "
          f"K1 {s2r['launches']['k1']} launches, {s2r['k1']['ms'] * 1e3:.4f} us a launch at "
          f"B={FIT_CANDIDATES} without actuation (bound {bnd['k1_fit']['bound_ms'] * 1e3:.4f} us, "
          f"{bnd['k1_fit']['bound_by']}); {card_line()}")
    total_s = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s, "total_s": total_s,
                       "phase_s": phase_s,
                       "k1_max_abs_err": k1_errs, "k1_float64": k1_f64, "native": nat,
                       "k2_vs_plain_max_abs_err": k2_err,
                       "k2_vs_general_max_abs_err": cross_err,
                       "k2_maze_vs_plain_max_abs_err": maze_err,
                       "k2_maze_vs_general_max_abs_err": maze_cross_err, "serve_maze": serve_mz,
                       "bounds": bnd, "k3_maze": k3_maze, "env_surface": surface,
                       "k3_vs_plain_max_abs_err": k3_err, "k4": k4, "ptxas": ptxas,
                       "small_checks": small, "serve_cartpole": serve_cp, "serve_quad2d": serve_q2,
                       "train": train, "lqr": lqr, "pid": pid, "ppo_extras": ppo_extras,
                       "mpc_solve": mpc_solve, "mpc": mpc, "ilqr": ilqr,
                       "linear_mpc": linear_mpc, "gp_mpc": gp_mpc, "cbf": cbf,
                       "firmware": firmware, "competition_sim_only": comp_sim,
                       "competition": comp, "learners": learners, "sim2real": s2r,
                       "experiment": experiment, "distributed": dist_res,
                       **res, **kernels_line}, f, indent=1, default=str)
    print(f"phases (s): {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    print(f"total {total_s:.1f} s")
    print(card_line())
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
