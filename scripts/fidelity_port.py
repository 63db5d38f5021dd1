#!/usr/bin/env python3
"""Numerical fidelity of the port's general-engine step against the
independent NumPy oracle (``tests/oracles/numpy_reference.py``, read in
place): the counterpart of ``benchmarks/fidelity.py``.

CartPole, the 2D and the 3D quadrotor from fixed seeds, in float32 and
float64, on the device given (the card by default), each stepped by
``ops/integrators.rk4_step`` of its dynamics (CartPole's and the 2D quad's
general-engine step; the JAX harness's cases); and ``quad3d_k1``, the 3D
general engine's own step, K1 (``ops/quad_substeps.quad3d_substeps``: one
RK4 substep of given motor forces; its float32 or float64 instance on the
card, its plain version on the CPU).  Two measures a case:

- ``step_max_ulp``, teacher-forced: one engine step from every oracle state
  along the trajectory against one oracle step (the fidelity bar: the JAX
  suite holds float64 to 4 ulp, tests/test_dynamics.py);
- ``traj_max_rel``: the free-running trajectories after N steps, for
  context (the quadrotor's attitude dynamics amplify any rounding).

Prints one JSON line; writes the cases only under ``--out``.

    python3 scripts/fidelity_port.py [--steps 100] [--device cpu]
        [--out results/fidelity_port.json]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(ROOT, "tests", "oracles", "numpy_reference.py")


def load_oracle():
    spec = importlib.util.spec_from_file_location("numpy_reference", ORACLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def max_ulp(got, want):
    """Largest elementwise difference in units in the last place of ``got``'s dtype."""
    want = np.asarray(want, got.dtype)
    eps = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return float(np.max(np.abs(got - want) / eps))


def max_rel(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6)))


def _const(v, x):
    import torch

    return torch.full((x.shape[0],), v, dtype=x.dtype, device=x.device)


def cartpole_case(oracle, steps):
    """(engine step on (B, nx) tensors, oracle step on one float64 state,
    x0, inputs (steps, nu), as benchmarks/fidelity.py draws them)."""
    from safe_control_gym_torch.envs.cartpole import cartpole_fc
    from safe_control_gym_torch.ops.integrators import rk4_step

    rng = np.random.default_rng(0)
    x0, forces = rng.normal(size=4) * 0.05, rng.normal(size=(steps, 1)) * 2.0
    pl, pm, cm, dt = 1.0, 0.1, 1.0, 0.02

    def step(x, u):
        return rk4_step(lambda a, b: cartpole_fc(a, b, _const(pl, a), _const(pm, a),
                                                 _const(cm, a)), x, u, dt)

    return step, lambda x, u: oracle.rk4(lambda a, b: oracle.cartpole_fc(a, b, pl, pm, cm),
                                         x, u, dt), x0, forces


def quad2d_case(oracle, steps):
    from safe_control_gym_torch.envs.quadrotor import J_DIAG, MASS, quad_fc_2d
    from safe_control_gym_torch.ops.integrators import rk4_step

    rng = np.random.default_rng(2)
    x0 = rng.normal(size=6) * 0.05
    forces = MASS * 9.8 / 4.0 * (1.0 + 0.05 * rng.normal(size=(steps, 4)))
    iyy, dt = float(J_DIAG[1]), 1.0 / 240.0

    def step(x, u):
        return rk4_step(lambda a, b: quad_fc_2d(a, b, _const(MASS, a), _const(iyy, a),
                                                _const(0.0, a), _const(0.0, a)), x, u, dt)

    return step, lambda x, u: oracle.rk4(lambda a, b: oracle.quad2d_fc(a, b, MASS, iyy),
                                         x, u, dt), x0, forces


def quad3d_case(oracle, steps, kernel=False):
    """The 3D quad by ``rk4_step`` of ``quad_fc_3d`` (the JAX harness's
    case), or with ``kernel`` by K1, the general engine's step."""
    import torch

    from safe_control_gym_torch.envs.quadrotor import J_DIAG, MASS, quad_fc_3d
    from safe_control_gym_torch.ops.integrators import rk4_step
    from safe_control_gym_torch.ops.quad_substeps import quad3d_substeps

    rng = np.random.default_rng(1)
    x0 = rng.normal(size=12) * 0.05
    forces = MASS * 9.8 / 4.0 * (1.0 + 0.05 * rng.normal(size=(steps, 4)))
    j, dt = np.asarray(J_DIAG), 1.0 / 240.0

    def step(x, u):
        jd = torch.as_tensor(j, dtype=x.dtype, device=x.device).expand(x.shape[0], 3).contiguous()
        ext = torch.zeros_like(x[:, :3])
        if kernel:  # one RK4 substep of the motor forces, no actuation
            return quad3d_substeps(x, u, ext, _const(MASS, x), jd, dt=dt, n_sub=1)
        return rk4_step(lambda a, b: quad_fc_3d(a, b, _const(MASS, a), jd, ext), x, u, dt)

    return step, lambda x, u: oracle.rk4(lambda a, b: oracle.quad3d_fc(a, b, MASS, j),
                                         x, u, dt), x0, forces


def quad3d_k1_case(oracle, steps):
    return quad3d_case(oracle, steps, kernel=True)


def run_case(case, oracle, steps, dtype, device):
    """(teacher-forced engine steps, oracle states, free-running engine
    trajectory, oracle trajectory) as NumPy arrays of ``dtype``."""
    import torch

    step, ostep, x0, forces = case(oracle, steps)
    x, want = x0.astype(np.float64), []
    for t in range(steps):
        x = ostep(x, forces[t].astype(np.float64))
        want.append(x.copy())
    want = np.stack(want)
    starts = np.concatenate([x0[None], want[:-1]], 0)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    got_steps = step(t(starts), t(forces)).cpu().numpy()
    xt, traj = t(x0[None]), []
    for k in range(steps):
        xt = step(xt, t(forces[k:k + 1]))
        traj.append(xt[0].cpu().numpy())
    np_dtype = got_steps.dtype
    return got_steps, want.astype(np_dtype), np.stack(traj), want.astype(np_dtype)


def main(steps=100, device=None, out=None):
    import torch

    from safe_control_gym_torch.utils.device import card_line, resolve_device

    dev = resolve_device(device)
    oracle = load_oracle()
    results = {"device": card_line(dev), "steps": steps, "cases": {}}
    for name, case in (("cartpole", cartpole_case), ("quad2d", quad2d_case),
                       ("quad3d", quad3d_case), ("quad3d_k1", quad3d_k1_case)):
        gs32, ws32, gt32, wt32 = run_case(case, oracle, steps, torch.float32, dev)
        gs64, ws64, _, _ = run_case(case, oracle, steps, torch.float64, dev)
        results["cases"][name] = {"f32_step_max_ulp": max_ulp(gs32, ws32),
                                  "f32_step_max_rel": max_rel(gs32, ws32),
                                  "f32_traj_max_rel": max_rel(gt32, wt32),
                                  "f64_step_max_ulp": max_ulp(gs64, ws64)}
    line = {"metric": "fidelity_vs_numpy_oracle", "device": results["device"], "steps": steps,
            **{f"{k}_{m}": v for k, c in results["cases"].items() for m, v in c.items()}}
    print(json.dumps(line), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    return line


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    main(a.steps, a.device, a.out)
