"""Carry env state and network weights across from the JAX package.

Network weights: a flax MLP's params ``{"params": {"Dense_i": {"kernel",
"bias"}}}`` as NumPy arrays load into the port's ``MLP`` (``layers[i]``,
``weight = kernel.T``), and an ``ActorCritic``'s (actor, critic, logstd)
into the port's, so both packages compute the same function.  The reverse
direction serves the tests' comparisons.

Env state: the JAX package's batched ``QuadState`` or ``CartPoleState``
reaches this module as a dict of NumPy arrays (field name -> array with a
leading batch axis; ``dist_sched`` as the nested dict of channel ->
``{"offsets": ..., "walk": ...}`` or an empty array).
:func:`quad_state_from_numpy` and :func:`cartpole_state_from_numpy` return
the port's state on a given device, so that both packages can start from
the same state: the offsets, the brownian walks and the adversary's
pending force and action offset included.  The PRNG key has no
counterpart in the port and is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_torch.envs.cartpole import CartPoleState
from safe_control_gym_torch.envs.quadrotor import QuadState

_INT_FIELDS = ("ctrl_step", "pyb_step", "env_seed", "episode_idx", "current_gate",
               "steps_at_goal")
_BOOL_FIELDS = ("cnstr_violation", "stepped_through_gate", "currently_collided",
                "at_goal_pos", "task_completed")
_FLOAT_FIELDS = ("x", "mass", "j_diag", "gates_eff", "obstacles_eff", "adv_force", "adv_act")


def _sched(sched, key: str, batch: int, dtype) -> np.ndarray:
    """A channel's (B, n) ``offsets`` or ``walk`` from the JAX schedule entry
    (a plain offsets array in older states)."""
    if isinstance(sched, dict):
        sched = sched.get(key)
    elif key == "walk":
        sched = None
    if sched is None:
        return np.zeros((batch, 0), dtype)
    return np.asarray(sched, dtype).reshape(batch, -1)


def _state_from_numpy(cls, fields, device, dtype, float_fields, int_fields, bool_fields):
    batch = np.asarray(fields["x"]).shape[0]

    def put(a, dt):
        return torch.as_tensor(np.array(a), device=device).to(dt)

    kw = {}
    for name in float_fields:
        kw[name] = put(np.asarray(fields[name], np.float32), dtype)
    for name in int_fields:
        kw[name] = put(np.asarray(fields[name]).astype(np.int32), torch.int32)
    for name in bool_fields:
        kw[name] = put(np.asarray(fields[name]).astype(bool), torch.bool)
    sched = fields.get("dist_sched", {})
    channels = ("observation", "action", "dynamics")
    kw["dist_offsets"] = {ch: put(_sched(sched.get(ch), "offsets", batch, np.int32), torch.int32)
                          for ch in channels}
    kw["dist_walk"] = {ch: put(_sched(sched.get(ch), "walk", batch, np.float32), dtype)
                       for ch in channels}
    return cls(**kw)


def quad_state_from_numpy(fields: dict, device, dtype=torch.float32) -> QuadState:
    """The port's ``QuadState`` from a batched JAX ``QuadState``'s fields."""
    return _state_from_numpy(QuadState, fields, device, dtype, _FLOAT_FIELDS, _INT_FIELDS,
                             _BOOL_FIELDS)


def cartpole_state_from_numpy(fields: dict, device, dtype=torch.float32) -> CartPoleState:
    """The port's ``CartPoleState`` from a batched JAX ``CartPoleState``'s
    fields."""
    return _state_from_numpy(CartPoleState, fields, device, dtype,
                             ("x", "pole_length", "pole_mass", "cart_mass", "adv_force", "adv_act"),
                             ("ctrl_step", "pyb_step", "env_seed", "episode_idx"),
                             ("cnstr_violation",))


def load_mlp(mlp, params) -> None:
    """Copy flax MLP params (NumPy, ``{"params": {"Dense_i": ...}}``) into
    the port's ``MLP`` in place."""
    tree = params["params"]
    if len(tree) != len(mlp.layers):
        raise ValueError(f"{len(tree)} flax layers for an MLP of {len(mlp.layers)}")
    with torch.no_grad():
        for i, layer in enumerate(mlp.layers):
            d = tree[f"Dense_{i}"]
            kernel = np.asarray(d["kernel"], np.float32)
            if kernel.shape != tuple(layer.weight.shape[::-1]):
                raise ValueError(f"Dense_{i}: kernel {kernel.shape} for weight "
                                 f"{tuple(layer.weight.shape)}")
            layer.weight.copy_(torch.tensor(kernel.T))
            layer.bias.copy_(torch.tensor(np.asarray(d["bias"], np.float32)))


def mlp_params(mlp) -> dict:
    """The port's ``MLP`` as flax-layout NumPy params."""
    return {"params": {f"Dense_{i}": {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                                      "bias": layer.bias.detach().cpu().numpy().copy()}
                       for i, layer in enumerate(mlp.layers)}}


def load_actor_critic(ac, actor_params, critic_params, logstd) -> None:
    """Copy a JAX ``ActorCritic``'s fields (NumPy trees) into the port's
    ``ActorCritic`` in place."""
    load_mlp(ac.actor, actor_params)
    load_mlp(ac.critic, critic_params)
    with torch.no_grad():
        ac.logstd.copy_(torch.tensor(np.asarray(logstd, np.float32)))


def actor_critic_params(ac):
    """The port's ``ActorCritic`` as flax-layout NumPy (actor, critic,
    logstd)."""
    return mlp_params(ac.actor), mlp_params(ac.critic), ac.logstd.detach().cpu().numpy().copy()
