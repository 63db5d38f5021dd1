"""Policy-in-kernel whole-rollout engine: PPO data collection in one launch.

Port of ``safe_control_gym_tpu/parallel/fast_policy.py`` (TPU kernel
``_policy_rollout_kernel``, :76).  K3, :func:`policy_rollout`, runs T
control steps for every env: the observation (the state rows, with the
observation white noise and the goal-horizon rows where the config has
them), the dual actor+critic MLP forward on it, a Box-Muller Gaussian
sample from Philox uniforms (``ops/philox.py``), its log-prob, the
normalized-action map, the control step K2 also runs (``step_rows``, with
the maze and the step noise where the config has them), and one record per
step.  CUDA tensors launch ``csrc/quad3d_policy_rollout.cu``; CPU tensors
take the plain version :func:`policy_rollout_plain`; anything else raises.

Record layout (the JAX rows, ``fast_policy.py:62-71``), stored (T, 2 D + 9,
B) with the batch last, D the observation's width (12 x ``obs_mul``): obs
0..D-1 | act | rew | done | trunc | v | logp | terminal obs, the post-step
observation masked to truncated steps for the GAE bootstrap (33 rows at D =
12).  Weights keep the packed dual-network layout of ``pack_weights``
(``fast_policy.py:296-330``).

Envelope: ``fast_env.supports(cfg, allow_normalized=True, allow_maze=True,
allow_goal_horizon=True)``, the JAX K3's (``fast_policy.py:236-237``): with
the competition maze (BASELINE config 5: gates, obstacles, the competition
cost, collision and completion done, action white noise and the uniform
dynamics force), the observation capped at ``MAX_OBS`` = 128 rows and the
maze at ``MAX_GATES`` gates and ``MAX_OBSTACLES`` obstacles.  The state rows
are K2's (``fast_env.total_rows``: 27, and the maze rows).  The PPO
trainer's envelope is narrower, as the JAX PPO's (``controllers/ppo.py:
207-210``): no maze.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from safe_control_gym_torch.ops import ctr_prng, philox
from safe_control_gym_torch.parallel import fast_env as FE
from safe_control_gym_torch.utils.device import resolve_device

TRAJ_ROWS = 33  # at the state's 12 observation rows

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
MAX_HIDDEN = 128  # the widths the policy kernels take, as the JAX kernels (fast_policy.py:227)


def check_hidden(h: int) -> None:
    """Raise for a hidden width the policy kernels do not take."""
    if not 1 <= h <= MAX_HIDDEN:
        raise ValueError(f"the policy kernels take hidden widths 1..{MAX_HIDDEN}, not {h}")


def check_obs(d: int) -> None:
    """Raise for an observation the observation instances do not take (0:
    not that instance)."""
    if not 0 <= d <= FE.MAX_OBS:
        raise ValueError(f"the policy kernels take observations of 1..{FE.MAX_OBS} rows, not {d}")


class ObsExtParams(ctypes.Structure):
    """Host mirror of ``ObsExt`` in ``csrc/obs_ext.cuh``: the observation
    instances' run-time observation (K3, K6, K8)."""

    _fields_ = [("obs_dim", ctypes.c_int), ("goal_blocks", ctypes.c_int),
                ("noise_std", ctypes.c_float), ("goal_last", ctypes.c_float)]


def obs_dim(p, nx: int) -> int:
    """The observation's width: the nx state rows and the goal rows."""
    return nx * (1 + FE.goal_blocks(p))


def obs_ext(p, nx: int):
    """The observation instance's parameters where the config's
    observation is more than the state (observation noise or goal rows),
    else None (the state-observation instances)."""
    nb = FE.goal_blocks(p)
    if p["obs_noise_std"] <= 0.0 and nb == 0:
        return None
    return ObsExtParams(obs_dim(p, nx), nb, p["obs_noise_std"],
                        float(p["goal_len"] - 1) if nb else 0.0)


def check_obs_ext_size(lib):
    """Raise unless the CUDA source's ``ObsExt`` has the host mirror's size."""
    if lib.obs_ext_params_size() != ctypes.sizeof(ObsExtParams):
        raise RuntimeError("ObsExt differs between fast_policy.py and csrc/obs_ext.cuh")


def _matvec(w, x):
    """``w @ x`` for (m, n) weights and a list of n (B,) rows, as the kernel
    sums: terms in input order, ``acc = acc + w[:, k] * x[k]``."""
    acc = w[:, 0:1] * x[0]
    for k in range(1, len(x)):
        acc = acc + w[:, k:k + 1] * x[k]
    return acc


def _act_fn(name):
    if name == "tanh":
        return torch.tanh
    if name == "relu":
        return lambda z: torch.maximum(z, torch.zeros_like(z))
    raise ValueError(f"K3 supports tanh and relu, not {name!r}")


def dual_mlp(weights, obs, nu: int, f):
    """The packed dual network's outputs on observation rows ``obs`` (a
    list of (B,) rows): the ``nu`` actor means and the value.  As the
    kernels, it runs the actor's and the critic's blocks of the packed
    layers apart and skips their zero blocks; output rows 0..nu-1 are the
    means and row nu the value (``pack_weights``)."""
    w1, b1, w2, b2, w3, b3, _ = weights
    H = w2.shape[0] // 2
    h1 = f(_matvec(w1, obs) + b1)
    a2 = f(_matvec(w2[:H, :H], list(h1[:H])) + b2[:H])
    c2 = f(_matvec(w2[H:, H:], list(h1[H:])) + b2[H:])
    mean = _matvec(w3[:nu, :H], list(a2)) + b3[:nu]
    value = (_matvec(w3[nu:nu + 1, H:], list(c2)) + b3[nu:nu + 1])[0]
    return mean, value


def gaussian_sample(mean, logstd, u, nu: int):
    """act = mean + exp(logstd) * eps and its log-prob, eps by Box-Muller
    on the 2 * nu uniforms ``u`` (radius draws 0..nu-1, angle draws
    nu..2nu-1), in the kernels' operation order (fast_policy.py:141-161)."""
    eps = philox.box_muller(u, nu)
    act = []
    logp = torch.zeros_like(mean[0])
    for i in range(nu):
        act.append(mean[i] + torch.exp(logstd[i]) * eps[i])
        logp = logp - 0.5 * (eps[i] * eps[i]) - logstd[i] - _HALF_LOG_2PI
    return act, logp


def terminal_obs(p, s_post, trunc, step_f, seed, it, env, goal_fn):
    """The record's terminal observation: the post-step state with fresh
    observation noise (draws from ``philox.OBS_TERM_BLOCK``, used on
    truncated steps only), then the goal rows at the index offset 2 (the
    new state's next step; JAX fast_policy.py:185-196), all masked to
    truncated steps: ``s * trunc`` on the state rows as the JAX kernel, 0 on
    the goal rows."""
    truncf = trunc.to(torch.float32)
    if p["obs_noise_std"] > 0.0:
        noised = FE.obs_noise_rows(p, s_post, seed, it, env, philox.OBS_TERM_BLOCK)
        rows = [torch.where(trunc, o, s) * truncf for o, s in zip(noised, s_post)]
    else:
        rows = [s * truncf for s in s_post]
    zero = torch.zeros_like(truncf)
    return rows + [torch.where(trunc, g, zero)
                   for g in FE.goal_ext_rows(p, step_f, 2, goal_fn)]


def policy_rollout_loop(p, rows, weights, seed, nx: int, nu: int, thrust_fn, step_fn,
                        step_row: int, goal_fn=None):
    """Plain policy-driven rollout of any engine: per step the observation
    (state rows 0..nx-1 with the observation noise, then the goal rows of
    ``goal_fn(p, step_rows)`` at the step row ``step_row`` plus 1:
    ``fast_env.obs_noise_rows``, ``goal_ext_rows``), the dual MLP on it, the
    Gaussian sample from Philox call site 0, the engine's action map
    ``thrust_fn(a)`` and control step ``step_fn(carry, thrust_rows,
    act_rows, it)`` (returning ``step_rows``' tuple), and one record: obs |
    act | rew | done | trunc | v | logp | terminal obs (:func:`terminal_obs`).
    Returns (rows, traj (T, 2 D + nu + 5, B)), D the observation's width
    (:func:`obs_dim`)."""
    f = _act_fn(p["mlp_act"])
    carry = list(rows.unbind(0))
    env = torch.arange(rows.shape[1], device=rows.device)
    records = []
    for it in range(p["steps"]):
        step_f = carry[step_row]
        obs = (FE.obs_noise_rows(p, carry[:nx], seed, it, env)
               + FE.goal_ext_rows(p, step_f, 1, goal_fn))
        mean, value = dual_mlp(weights, obs, nu, f)
        act, logp = gaussian_sample(mean, weights[6], philox.uniforms(seed, it, env, 2 * nu), nu)
        thr = [thrust_fn(a) for a in act]
        carry, rew, done, trunc, _, s_post = step_fn(carry, thr, act, it)
        records.append(torch.stack(
            obs + act + [rew, done.to(torch.float32), trunc.to(torch.float32), value, logp]
            + terminal_obs(p, s_post, trunc, step_f, seed, it, env, goal_fn)))
    return torch.stack(carry), torch.stack(records)


def policy_rollout_plain(p, rows, weights, seed):
    """Plain PyTorch version of K3: ``p['steps']`` policy-driven control
    steps on ``rows`` (``fast_env.total_rows(p)``, B).  The step's noise
    (action white noise, the uniform force: ``fast_env.step_noise``) takes
    the call's seed, as K2's does; the thrust it noises is the policy's
    (pre-noise) thrust, which the reward's action terms read, and the
    record keeps the pre-noise action (JAX fast_policy.py:150-173).

    ``weights``: (w1, b1, w2, b2, w3, b3, logstd) from :func:`pack_weights`;
    ``seed``: int32 tensor of one element.  Returns (rows, traj (T, 2 D +
    9, B))."""
    if p["normalized"]:
        def thrust(a):
            return (1.0 + p["norm_act_scale"] * torch.clamp(a, -1.0, 1.0)) * p["hover_thrust"]
    else:
        def thrust(a):
            return torch.clamp(a, p["a_low"], p["a_high"])
    env = torch.arange(rows.shape[1], device=rows.device)
    return policy_rollout_loop(
        p, rows, weights, seed, FE._NX, 4, thrust,
        lambda c, thr, act, it: FE.step_rows(p, c, thr, act, FE.step_noise(p, seed, it, env)),
        FE._R_STEP, FE.eval_goal)


def maze_instance(p) -> bool:
    """Whether a config runs K3's maze instances: the maze, the action white
    noise or the uniform dynamics force (K2's maze instance's envelope)."""
    return p["maze"] or p["act_noise_std"] > 0.0 or p["dyn_uniform"] is not None


MLP_CHUNK = 32  # csrc/policy_mlp.cuh: second-layer units a run-time-width kernel sums at a time
# K3's launch (csrc/quad3d_policy_rollout.cu): GROUP lanes of a warp per env
# (csrc/lane_group.cuh), BLOCK threads a block, the card's shared memory a
# block may take.
GROUP = 8
BLOCK = 128
MAX_SMEM = 232448


def group_row(hidden: int, obs_dim: int = 0) -> int:
    """Shared-memory floats of one env's group (``lane_group.cuh::
    mlp_group_row``, ``obs_ext.cuh::obs_group_row``): both nets' two hidden
    layers, at a stride that puts the groups of a warp in different banks,
    and for the observation instance (``obs_dim`` > 0) the observation row
    before them, rounded up to a multiple of 32 floats."""
    return 4 * (-(-hidden // 8) * 8) + 4 + 32 * -(-obs_dim // 32)


def launch_plan(B: int, hidden: int, group: int | None = None, obs_dim: int = 0):
    """K3's launch for B envs at hidden width ``hidden``: (lanes per env,
    threads per block, blocks, dynamic shared-memory bytes).  Each env is one
    group of ``group`` lanes (``GROUP`` where None) inside a warp, BLOCK //
    group envs a block, each group with its row of shared memory (with the
    observation row of width ``obs_dim`` for the observation instance); the
    lanes of the last block's groups past env B - 1 run env B - 1 and store
    nothing.  The kernel refuses a group size it was not built with."""
    g = GROUP if group is None else group
    if g not in (4, 8, 16, 32):
        raise ValueError(f"a lane group holds 4, 8, 16 or 32 lanes, not {g}")
    check_hidden(hidden)
    check_obs(obs_dim)
    smem = BLOCK // g * group_row(hidden, obs_dim) * 4
    if smem > MAX_SMEM:
        raise ValueError(f"K3's plan needs {smem} bytes of shared memory a block, over {MAX_SMEM}")
    return g, BLOCK, -(-B // (BLOCK // g)), smem


def kernel_weights(weights):
    """The kernels' flat weight vector from :func:`pack_weights`' tuple
    (``csrc/policy_mlp.cuh``): w1 | b1 | w2^T | b2 | w3^T | b3 | logstd, each
    row of w1 zero-padded to a multiple of 4, the actor's and the critic's
    columns of w2^T each zero-padded to HP = H rounded up to a multiple of
    MLP_CHUNK, and b1 and b2 to a multiple of 4, so that the kernels' float4
    loads stay aligned.  At H = 64 it is the packed tuple, transposed and
    concatenated."""
    w1, b1, w2, b2, w3, b3, logstd = weights
    H2 = w1.shape[0]
    H = H2 // 2
    pad = -w1.shape[1] % 4
    if pad:
        w1 = torch.cat([w1, w1.new_zeros((H2, pad))], 1)
    w2t = w2.T
    if H % MLP_CHUNK:
        z = w2.new_zeros((H2, -H % MLP_CHUNK))
        w2t = torch.cat([w2t[:, :H], z, w2t[:, H:], z], 1)

    def flat4(t):
        t = t.reshape(-1)
        return torch.cat([t, t.new_zeros(-t.numel() % 4)]) if t.numel() % 4 else t

    return torch.cat([w1.reshape(-1), flat4(b1), w2t.reshape(-1), flat4(b2),
                      w3.T.reshape(-1), b3.reshape(-1), logstd.reshape(-1)]).contiguous()


def policy_rollout(p, rows, weights, seed):
    """K3: the rollout of :func:`policy_rollout_plain`.

    CPU tensors take the plain version; CUDA float32 tensors launch
    ``csrc/quad3d_policy_rollout.cu`` (its observation instance where the
    observation is more than the state, :func:`obs_ext`; its maze instances
    where :func:`maze_instance`); anything else raises."""
    tensors = [rows, seed, *weights]
    if all(t.device.type == "cpu" for t in tensors):
        return policy_rollout_plain(p, rows, weights, seed)
    B = rows.shape[-1]
    H2, D = weights[0].shape[0], obs_dim(p, FE._NX)
    shapes = ((H2, D), (H2, 1), (H2, H2), (H2, 1), (8, H2), (8, 1), (4,))
    ok = (tuple(rows.shape) == (FE.total_rows(p), B) and seed.numel() == 1
          and seed.dtype == torch.int32
          and all(tuple(t.shape) == s for t, s in zip(weights, shapes))
          and all(t.device == rows.device and t.device.type == "cuda" for t in tensors)
          and all(t.dtype == torch.float32 for t in [rows, *weights]))
    if not ok or H2 % 2 or not 1 <= H2 // 2 <= MAX_HIDDEN or p["mlp_act"] not in ("tanh", "relu"):
        raise ValueError(
            f"policy_rollout takes float32 rows ({FE.total_rows(p)}, B), packed weights of hidden "
            f"1..{MAX_HIDDEN} "
            f"for obs {D} and an int32 seed on one CUDA device, tanh or relu; got rows "
            f"{tuple(rows.shape)} {rows.dtype} {rows.device}, "
            f"weights {[tuple(t.shape) for t in weights]}, act {p['mlp_act']!r}")
    from safe_control_gym_torch import kernels

    rows = rows.contiguous()
    out = torch.empty_like(rows)
    traj = torch.empty((p["steps"], 2 * D + 9, B), dtype=torch.float32, device=rows.device)
    if B == 0:
        return out, traj
    wflat = kernel_weights(weights)
    params = FE.kernel_params(p)
    lib = kernels.lib()
    args = (int(p["normalized"]), int(p["mlp_act"] == "relu"), float(p["norm_act_scale"]),
            float(p["hover_thrust"]), H2 // 2, seed.data_ptr(), wflat.data_ptr(),
            rows.data_ptr(), out.data_ptr(), traj.data_ptr(), B)
    ext = obs_ext(p, FE._NX)
    if ext is not None:
        check_obs_ext_size(lib)
    plan = launch_plan(B, H2 // 2, obs_dim=0 if ext is None else D)
    maze = maze_instance(p)
    if maze:
        if lib.quad3d_rollout_params_size() != ctypes.sizeof(params):
            raise RuntimeError("RolloutParams differs between fast_env.py and quad3d_rollout.cu")
        code = lib.quad3d_policy_rollout_maze(
            ctypes.addressof(params), None if ext is None else ctypes.addressof(ext), *args,
            *plan, kernels.stream_ptr(rows.device))
    elif ext is None:
        code = lib.quad3d_policy_rollout(ctypes.addressof(params), *args, *plan,
                                         kernels.stream_ptr(rows.device))
    else:
        code = lib.quad3d_policy_rollout_obs(ctypes.addressof(params), ctypes.addressof(ext),
                                             *args, *plan, kernels.stream_ptr(rows.device))
    kernels.check(code, "quad3d_policy_rollout")
    policy_rollout.launches += 1
    policy_rollout.obs_launches += ext is not None
    policy_rollout.maze_launches += maze
    return out, traj


# Launches of K3, and of its observation and maze instances among them.
policy_rollout.launches = policy_rollout.obs_launches = policy_rollout.maze_launches = 0


def unpack_record(traj, obs_dim: int, nu: int):
    """A (T, 2 obs_dim + nu + 5, B) record of any policy engine -> the PPO
    field dict in (T, B, ...) layout."""
    od = obs_dim

    def mat(a, b):
        return traj[:, a:b].transpose(1, 2)

    done = traj[:, od + nu + 1]
    return {"obs": mat(0, od), "act": mat(od, od + nu), "rew": traj[:, od + nu], "done": done,
            "mask": 1.0 - done, "trunc": traj[:, od + nu + 2], "v": traj[:, od + nu + 3],
            "logp": traj[:, od + nu + 4], "term_obs": mat(od + nu + 5, 2 * od + nu + 5)}


def pack_weights(actor, critic, logstd):
    """Port actor/critic ``MLP``s -> the fused dual-network matrices
    (fast_policy.py:296-330): hidden rows 0..H-1 actor, H..2H-1 critic; w2
    block-diagonal; output rows 0..nu-1 actor means, nu value, the rest
    zero (the layout of all three policy engines)."""
    a = [layer for layer in actor.layers]
    c = [layer for layer in critic.layers]
    H = a[0].weight.shape[0]
    with torch.no_grad():
        w1 = torch.cat([a[0].weight, c[0].weight], 0)
        b1 = torch.cat([a[0].bias, c[0].bias])[:, None]
        w2 = torch.zeros((2 * H, 2 * H), dtype=w1.dtype, device=w1.device)
        w2[:H, :H], w2[H:, H:] = a[1].weight, c[1].weight
        b2 = torch.cat([a[1].bias, c[1].bias])[:, None]
        nu = a[2].weight.shape[0]
        w3 = torch.zeros((8, 2 * H), dtype=w1.dtype, device=w1.device)
        w3[:nu, :H], w3[nu:nu + 1, H:] = a[2].weight, c[2].weight
        b3 = torch.zeros((8, 1), dtype=w1.dtype, device=w1.device)
        b3[:nu, 0], b3[nu, 0] = a[2].bias, c[2].bias[0]
        return (w1.contiguous(), b1.contiguous(), w2, b2.contiguous(), w3, b3,
                logstd.detach().clone())


def observe_rows(p, env, x, step_f, generator=None):
    """The env's observation of the states ``x`` (B, nx) at control-step
    rows ``step_f`` (JAX fast_policy.py:361-386, quadrotor._obs): where the
    config has observation white noise and a ``generator`` is given, ``x``
    plus ``std`` times standard normals drawn from it; then the goal rows of
    the env's goal table at ``clip(step + 1 + i, len - 1)`` (tracking) or
    the static goal (stabilization), clean."""
    std = p["obs_noise_std"]
    if std > 0.0 and generator is not None:
        x = x + std * torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    nb = FE.goal_blocks(p)
    if nb == 0:
        return x
    nx, B = x.shape[1], x.shape[0]
    xg = torch.as_tensor(np.asarray(env.x_goal, np.float32), device=x.device).reshape(-1, nx)
    if p["task"] == "stab":
        return torch.cat([x, xg.reshape(1, nx).expand(B, nx)], -1)
    steps = step_f.to(torch.int64)
    idx = torch.clamp(steps[:, None] + 1 + torch.arange(nb, device=x.device),
                      0, xg.shape[0] - 1)
    return torch.cat([x, xg[idx].reshape(B, -1)], -1)


class FastPolicyRollout:
    """Host wrapper: one launch = T policy-driven env steps for B envs,
    returning the whole PPO trajectory record."""

    def __init__(self, env, num_envs: int, steps_per_call: int, mlp_hidden: int = 64,
                 mlp_act: str = "tanh", device=None):
        self.env = env
        self.B = num_envs
        self.T = steps_per_call
        self.H = mlp_hidden
        self.device = resolve_device(device)
        _act_fn(mlp_act)
        check_hidden(mlp_hidden)
        self.params = FE.build_engine_params(env, steps_per_call, allow_normalized=True,
                                             allow_maze=True, allow_goal_horizon=True)
        self.params["mlp_act"] = mlp_act
        self.obs_dim = obs_dim(self.params, FE._NX)
        self.traj_rows = 2 * self.obs_dim + 9
        self.n_rows = FE.total_rows(self.params)
        self._auto_seed = 1

    def reset(self, seed: int = 0, env_seeds=None):
        """Fresh packed rows: episode 0 of ``env_seeds`` (int32, (B,)) or of
        the port's per-env seeds for ``seed``."""
        if env_seeds is None:
            env_seeds = ctr_prng.env_seeds_from_seed(seed, self.B, self.device)
        return FE.reset_rows(self.params, torch.as_tensor(env_seeds, device=self.device))

    pack_weights = staticmethod(pack_weights)

    def unpack_traj(self, traj):
        """(T, 2 D + 9, B) record -> PPO field dict in (T, B, ...) layout."""
        return unpack_record(traj, self.obs_dim, 4)

    def states(self, rows):
        """(B, 12) state matrix from packed rows."""
        return rows[:FE._NX].T

    def pack(self, env_states):
        """Pack a batched general-engine ``QuadState`` into rows (K2's
        ``FastQuadRollout.pack``: the maze rows included)."""
        return FE.pack_states(self.params, env_states, self.device)

    def observe(self, rows, generator=None):
        """(B, D) observation from packed rows: :func:`observe_rows` at the
        step row (the GAE bootstrap's and the initial observation)."""
        return observe_rows(self.params, self.env, self.states(rows), rows[FE._R_STEP], generator)

    def run(self, rows, weights, seed=None):
        """One launch = T policy-driven env steps.  ``weights``: the tuple
        of :meth:`pack_weights`; ``seed``: int or int32 tensor of one
        element (one per call: it keys the call's Philox stream).  Returns
        (new rows, traj record)."""
        if seed is None:
            seed = self._auto_seed
            self._auto_seed += 1
        if not torch.is_tensor(seed):
            seed = torch.tensor([seed], dtype=torch.int32, device=self.device)
        return policy_rollout(self.params, rows, weights, seed)
