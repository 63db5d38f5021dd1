"""Carry env state across from the JAX package.

The JAX package's batched ``QuadState`` reaches this module as a dict of
NumPy arrays (field name -> array with a leading batch axis; ``dist_sched``
as the nested dict of channel -> ``{"offsets": ..., "walk": ...}`` or an
empty array).  :func:`quad_state_from_numpy` returns the port's
``QuadState`` on a given device, so that both packages can start from the
same state.  The PRNG key and the adversary fields have no counterpart in
the port and are dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_torch.envs.quadrotor import QuadState

_INT_FIELDS = ("ctrl_step", "pyb_step", "env_seed", "episode_idx", "current_gate",
               "steps_at_goal")
_BOOL_FIELDS = ("cnstr_violation", "stepped_through_gate", "currently_collided",
                "at_goal_pos", "task_completed")
_FLOAT_FIELDS = ("x", "mass", "j_diag", "gates_eff", "obstacles_eff")


def _offsets(sched, batch: int) -> np.ndarray:
    """A channel's (B, n) int32 offsets from the JAX schedule entry."""
    if isinstance(sched, dict):
        sched = sched.get("offsets")
    if sched is None:
        return np.zeros((batch, 0), np.int32)
    return np.asarray(sched, np.int32).reshape(batch, -1)


def quad_state_from_numpy(fields: dict, device, dtype=torch.float32) -> QuadState:
    """The port's ``QuadState`` from a batched JAX ``QuadState``'s fields."""
    batch = np.asarray(fields["x"]).shape[0]

    def put(a, dt):
        return torch.as_tensor(np.array(a), device=device).to(dt)

    kw = {}
    for name in _FLOAT_FIELDS:
        kw[name] = put(np.asarray(fields[name], np.float32), dtype)
    for name in _INT_FIELDS:
        kw[name] = put(np.asarray(fields[name]).astype(np.int32), torch.int32)
    for name in _BOOL_FIELDS:
        kw[name] = put(np.asarray(fields[name]).astype(bool), torch.bool)
    sched = fields.get("dist_sched", {})
    kw["dist_offsets"] = {
        ch: put(_offsets(sched.get(ch), batch), torch.int32)
        for ch in ("observation", "action", "dynamics")
    }
    return QuadState(**kw)
