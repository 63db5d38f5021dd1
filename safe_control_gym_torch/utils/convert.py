"""Carry env state and network weights across from the JAX package.

Network weights: a flax MLP's params ``{"params": {"Dense_i": {"kernel",
"bias"}}}`` as NumPy arrays load into the port's ``MLP`` (``layers[i]``,
``weight = kernel.T``), and an ``ActorCritic``'s (actor, critic, logstd)
into the port's, so both packages compute the same function.  The reverse
direction serves the tests' comparisons.  A flax ``CNN``'s params
(``Conv_i`` kernels (kh, kw, in, out), ``Dense_i``) load into the port's
``CNN``, a flax ``RNN``'s ``GRUCell_0`` (``ir``/``iz``/``in`` with biases,
``hr``/``hz`` without, ``hn`` with) into the port's ``RNN``, and
:func:`fused_weights` gives the 2H-wide network of PPO's ``fused_update``
from flax actor and critic params.

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


def _dense(d):
    """(weight, bias) in torch layout of a flax Dense's NumPy params (bias
    None where the Dense has none)."""
    w = np.asarray(d["kernel"], np.float32).T
    return w, (np.asarray(d["bias"], np.float32) if "bias" in d else None)


def _copy(param, value) -> None:
    value = torch.as_tensor(np.array(value))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} for a parameter of {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def load_cnn(cnn, params) -> None:
    """Copy flax CNN params (NumPy) into the port's ``CNN`` in place: conv
    kernels (kh, kw, in, out) -> weights (out, in, kh, kw); the dense rows
    keep flax's NHWC flatten, which the port's CNN keeps too."""
    tree = params["params"]
    for i, conv in enumerate(cnn.convs):
        d = tree[f"Conv_{i}"]
        _copy(conv.weight, np.asarray(d["kernel"], np.float32).transpose(3, 2, 0, 1))
        _copy(conv.bias, np.asarray(d["bias"], np.float32))
    for i, layer in enumerate((cnn.dense, cnn.out)):
        w, b = _dense(tree[f"Dense_{i}"])
        _copy(layer.weight, w)
        _copy(layer.bias, b)


def load_rnn(rnn, params) -> None:
    """Copy a flax RNN's ``GRUCell_0`` params (NumPy) into the port's
    ``RNN`` in place (the gates stacked r, z, n)."""
    g = params["params"]["GRUCell_0"]
    cell = rnn.cell
    ins = [_dense(g[k]) for k in ("ir", "iz", "in")]
    _copy(cell.inp.weight, np.concatenate([w for w, _ in ins], 0))
    _copy(cell.inp.bias, np.concatenate([b for _, b in ins], 0))
    _copy(cell.h_rz.weight, np.concatenate([_dense(g[k])[0] for k in ("hr", "hz")], 0))
    w, b = _dense(g["hn"])
    _copy(cell.h_n.weight, w)
    _copy(cell.h_n.bias, b)


def fused_weights(actor_params, critic_params):
    """The fused network of PPO's ``fused_update`` from flax actor and
    critic MLP params (NumPy): [(W1, b1), (W2, b2), (W3, b3)] in torch
    layout (weight (out, in)), hidden layers concatenated actor first, the
    cross blocks zero (the JAX package's ``fused_losses``)."""
    a, c = actor_params["params"], critic_params["params"]
    layers = []
    for i in range(3):
        (wa, ba), (wc, bc) = _dense(a[f"Dense_{i}"]), _dense(c[f"Dense_{i}"])
        if i == 0:
            w = np.concatenate([wa, wc], 0)
        else:
            w = np.zeros((wa.shape[0] + wc.shape[0], wa.shape[1] + wc.shape[1]), np.float32)
            w[:wa.shape[0], :wa.shape[1]] = wa
            w[wa.shape[0]:, wa.shape[1]:] = wc
        layers.append((w, np.concatenate([ba, bc])))
    return layers
