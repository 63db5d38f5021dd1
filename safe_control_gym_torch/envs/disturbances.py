"""Batched disturbance injection: every kind of the JAX package.

Port of ``safe_control_gym_tpu/envs/disturbances.py``: ``impulse`` and
``step`` (``disturbances.py:138-163``), ``uniform`` (:164-170), ``white_noise``
(:171-175) on every channel, ``periodic`` (:176-183), ``brownian`` (:184-186,
with ``evolve`` :95-116 and its walk state) and ``state_dependent``
(:187-190).  A channel's YAML list compiles to a ``CompiledDisturbances``
program, a function of the per-episode schedule (randomized offsets and
the brownian walk), the step counters, the env's identity (for the noisy
kinds) and the env state (for ``state_dependent``).  The randomized offsets
are drawn at reset from the counter PRNG (``envs/quadrotor.py``,
``envs/cartpole.py``), so they need no carried random stream.

Noisy kinds: the JAX package draws them from a threefry key carried in the
env state, whose bits the port cannot reproduce.  The port draws them from
Philox (``ops/philox.py``) keyed on ``(env_seed, episode_idx)`` and counted
by ``(ctrl_step, entry, block, site)``, where ``entry`` is the entry's index
in the channel's list and ``site`` the channel's call site (action 1,
observation 2, dynamics 3): white noise is Box-Muller on each pair of
draws, uniform ``u * (high - low) + low`` on one draw a dim, the periodic
kind's phase ``-pi + u * 2 pi`` (a fresh phase each application, as the JAX
package draws one), and the brownian walk's increment ``std * sqrt(ctrl_dt)``
times a Box-Muller normal (its entry's draws in ``evolve``; ``apply`` adds
the walk and draws nothing).  The noise is then a pure function of the
env's identity and step, with no generator to carry, and the CPU and CUDA
give the same stream.  It matches the JAX package's in distribution only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from safe_control_gym_torch.ops import philox

# Call site (4th Philox counter word) of each channel's noisy kinds.
NOISE_SITES = {"action": philox.SITE_ACTION, "observation": philox.SITE_OBS,
               "dynamics": philox.SITE_DYNAMICS}


@dataclasses.dataclass(frozen=True)
class _Dist:
    kind: str  # impulse | step | uniform | white_noise | periodic | brownian | state_dependent
    dim: int
    mask: Optional[np.ndarray]
    magnitude: float = 1.0
    step_offset: Optional[int] = None  # None -> randomized per episode
    duration: int = 1
    decay_rate: float = 1.0
    std: Optional[np.ndarray] = None  # white noise and brownian, (dim,)
    low: Optional[np.ndarray] = None  # uniform, (dim,)
    high: Optional[np.ndarray] = None
    scale: float = 1.0  # periodic
    frequency: float = 1.0
    coeff: Optional[np.ndarray] = None  # state_dependent: -coeff * x[state_index]
    state_index: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class CompiledDisturbances:
    """One channel's disturbance program."""

    dists: Sequence[_Dist]
    dim: int
    max_step: int  # EPISODE_LEN_SEC / CTRL_TIMESTEP (disturbances.py:112)
    site: Optional[int] = None  # the channel's Philox call site (noisy kinds)
    pyb_timestep: float = 1.0  # the periodic kind's clock
    ctrl_timestep: float = 0.02  # the brownian walk's step
    # The entries' constants as tensors, made once per (dtype, device): a
    # tensor made from host data each step is a host-to-device copy, which
    # synchronizes the host with the card.
    _consts: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def _const(self, entry: int, name: str, dtype, device):
        key = (entry, name, dtype, device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(getattr(self.dists[entry], name),
                                                    dtype=dtype, device=device)
        return t

    @property
    def num_scheduled(self) -> int:
        """Entries needing a per-episode sampled offset."""
        return sum(1 for d in self.dists
                   if d.kind in ("impulse", "step") and d.step_offset is None)

    @property
    def walk_dim(self) -> int:
        """Float state carried by the brownian entries (each its dim)."""
        return sum(d.dim for d in self.dists if d.kind == "brownian")

    def evolve(self, walk, ctrl_step, identity):
        """The brownian walks one control step on (disturbances.py:95-116):
        ``W + std * sqrt(ctrl_dt) * N``, N a Box-Muller normal of each
        brownian entry's Philox draws at ``ctrl_step``.  walk: (B,
        walk_dim); returned unchanged without brownian entries."""
        if not self.walk_dim:
            return walk
        env_seed, episode_idx = identity
        parts, wi = [], 0
        for entry, d in enumerate(self.dists):
            if d.kind != "brownian":
                continue
            u = philox.block_uniforms(ctrl_step, entry, self.site, env_seed, episode_idx,
                                      2 * d.dim)
            step = self._const(entry, "std", walk.dtype, walk.device) \
                * float(np.sqrt(self.ctrl_timestep))
            parts.append(walk[:, wi:wi + d.dim]
                         + step * philox.box_muller(u, d.dim).T.to(walk.dtype))
            wi += d.dim
        return torch.cat(parts, -1)

    def apply(self, offsets, ctrl_step, target, identity=None, pyb_step=None, x=None,
              walk=None):
        """Apply all entries in order (disturbances.py:69-79, :118-193).

        offsets: (B, num_scheduled) int32; ctrl_step: (B,) int32;
        target: (B, dim); identity: the envs' ``(env_seed, episode_idx)``
        int32 tensors, which key the noisy kinds; pyb_step: (B,) int32, the
        periodic kind's clock; x: (B, nx) the env state, which the
        state_dependent kind reads; walk: (B, walk_dim), the brownian
        entries' walks."""
        dtype = target.dtype
        out = target
        si = wi = 0
        for entry, d in enumerate(self.dists):
            mask = None if d.mask is None else self._const(entry, "mask", dtype, target.device)
            if d.kind == "periodic":
                # scale * sin(2 pi f t + phase), a fresh uniform phase in
                # [-pi, pi) each application (disturbances.py:176-183).
                env_seed, episode_idx = identity
                u = philox.block_uniforms(ctrl_step, entry, self.site, env_seed, episode_idx,
                                          d.dim).T.to(dtype)
                phase = -math.pi + u * (2.0 * math.pi)
                t = pyb_step.to(dtype)[:, None] * self.pyb_timestep
                noise = d.scale * torch.sin(2.0 * math.pi * d.frequency * t + phase)
                out = out + (noise if mask is None else noise * mask)
                continue
            if d.kind == "brownian":
                w = walk[:, wi:wi + d.dim].to(dtype)
                wi += d.dim
                out = out + (w if mask is None else w * mask)
                continue
            if d.kind == "state_dependent":
                # A friction-like -coeff * x[state_index] (disturbances.py:187-190).
                coeff = self._const(entry, "coeff", dtype, target.device)
                noise = coeff * x[:, self._const(entry, "state_index", torch.int64,
                                                 x.device)].to(dtype)
                out = out - (noise if mask is None else noise * mask)
                continue
            if d.kind == "uniform":
                # uniform(sub, (dim,)) * (high - low) + low (disturbances.py:234-242).
                env_seed, episode_idx = identity
                u = philox.block_uniforms(ctrl_step, entry, self.site, env_seed, episode_idx,
                                          d.dim).T.to(dtype)
                lo = self._const(entry, "low", dtype, target.device)
                hi = self._const(entry, "high", dtype, target.device)
                noise = u * (hi - lo) + lo
                if d.mask is not None:
                    noise = noise * mask
                out = out + noise
                continue
            if d.kind == "white_noise":
                # jax.random.normal(sub, (dim,)) * std (disturbances.py:171-175).
                env_seed, episode_idx = identity
                u = philox.block_uniforms(ctrl_step, entry, self.site, env_seed, episode_idx,
                                          2 * d.dim)
                std = self._const(entry, "std", dtype, target.device)
                noise = philox.box_muller(u, d.dim).T.to(dtype) * std
                if d.mask is not None:
                    noise = noise * mask
                out = out + noise
                continue
            if d.step_offset is None:
                offset = offsets[:, si]
                si += 1
            else:
                offset = torch.full_like(ctrl_step, int(d.step_offset))
            if d.kind == "impulse":
                # Triangle/square pulse around the peak step
                # (disturbances.py:128-143).
                peak = offset + int(d.duration / 2)
                peak_offset = (ctrl_step - peak).abs().to(dtype)
                decay = torch.where(
                    peak_offset < d.duration / 2,
                    torch.pow(self._const(entry, "decay_rate", dtype, target.device),
                              peak_offset),
                    torch.zeros((), dtype=dtype, device=target.device),
                )
                noise = torch.where(ctrl_step >= offset, d.magnitude * decay,
                                    torch.zeros_like(decay))
            else:
                noise = torch.where(
                    ctrl_step >= offset,
                    torch.full(ctrl_step.shape, d.magnitude, dtype=dtype,
                               device=target.device),
                    torch.zeros(ctrl_step.shape, dtype=dtype, device=target.device),
                )
            noise = noise[:, None]
            if d.mask is not None:
                noise = noise * mask
            out = out + noise
        return out


def build_disturbances(
    specs: Optional[Sequence[dict]],
    dim: int,
    episode_len_sec: float,
    ctrl_freq: int,
    channel: Optional[str] = None,
    pyb_freq: Optional[int] = None,
) -> Optional[CompiledDisturbances]:
    """Compile one channel's YAML spec list (reference
    create_disturbance_list, disturbances.py:315-333); ``channel`` names
    the channel (observation, action or dynamics), whose call site keys
    its noisy kinds; ``pyb_freq`` sets the periodic kind's clock
    (``ctrl_freq`` where None)."""
    if not specs:
        return None
    dists = []
    for spec in specs:
        spec = dict(spec)
        kind = spec.pop("disturbance_func")
        mask = spec.pop("mask", None)
        if mask is not None:
            mask = np.asarray(mask, dtype=float)
            if mask.shape != (dim,):
                raise ValueError(f"disturbance mask must have shape ({dim},)")
        if kind == "impulse":
            d = _Dist(
                kind="impulse", dim=dim, mask=mask,
                magnitude=float(spec.get("magnitude", 1.0)),
                step_offset=spec.get("step_offset"),
                duration=int(spec.get("duration", 1)),
                decay_rate=float(spec.get("decay_rate", 1.0)),
            )
            if d.duration < 1 or not 0.0 < d.decay_rate <= 1.0:
                raise ValueError("impulse needs duration >= 1 and 0 < decay_rate <= 1")
        elif kind == "step":
            d = _Dist(
                kind="step", dim=dim, mask=mask,
                magnitude=float(spec.get("magnitude", 1.0)),
                step_offset=spec.get("step_offset"),
            )
        elif kind == "uniform":
            d = _Dist(kind="uniform", dim=dim, mask=mask,
                      low=np.broadcast_to(np.asarray(spec.get("low", 0.0), float), (dim,)).copy(),
                      high=np.broadcast_to(np.asarray(spec.get("high", 1.0), float), (dim,)).copy())
        elif kind in ("white_noise", "brownian"):
            d = _Dist(kind=kind, dim=dim, mask=mask, std=np.broadcast_to(
                np.asarray(spec.get("std", 1.0), float), (dim,)).copy())
        elif kind == "periodic":
            d = _Dist(kind="periodic", dim=dim, mask=mask, scale=float(spec.get("scale", 1.0)),
                      frequency=float(spec.get("frequency", 1.0)))
        elif kind == "state_dependent":
            if spec.get("state_index") is None:
                raise ValueError("state_dependent needs state_index")
            state_index = np.asarray(spec["state_index"], np.int64).reshape(-1)
            if state_index.shape[0] != dim:
                raise ValueError(f"state_dependent needs {dim} state indices")
            d = _Dist(kind="state_dependent", dim=dim, mask=mask, state_index=state_index,
                      coeff=np.broadcast_to(np.asarray(spec.get("coeff", 1.0), float),
                                            (dim,)).copy())
        else:
            raise ValueError(f"unknown disturbance_func {kind!r}")
        if d.kind not in ("impulse", "step", "state_dependent") and channel not in NOISE_SITES:
            raise ValueError(f"the noisy kind {kind!r} needs a channel (its Philox call site)")
        dists.append(d)
    return CompiledDisturbances(
        dists=tuple(dists), dim=dim, max_step=int(episode_len_sec * ctrl_freq),
        site=NOISE_SITES.get(channel), pyb_timestep=1.0 / (pyb_freq or ctrl_freq),
        ctrl_timestep=1.0 / ctrl_freq)


def scheduled_offsets(progs, u_all, first_slot: int, single_slot: int, max_steps: int):
    """Each channel's randomized step offsets, (B, n) int32, from an env's
    counter draws ``u_all`` (n_slots, B), both ``floor(u * max_steps)``: a
    single one on the dynamics channel from slot ``single_slot``, as the JAX
    package draws it (quadrotor.py:722-731, cartpole.py:298-307); every
    other from the slots at ``first_slot`` on, in channel order (the JAX
    package's threefry ``randint``, disturbances.py:81-93, which the port
    matches in distribution only).  ``progs``: channel -> program or None."""
    out, k = {}, first_slot
    for ch, prog in progs.items():
        n = prog.num_scheduled if prog is not None else 0
        if ch == "dynamics" and n == 1:
            rows = u_all[single_slot:single_slot + 1]
        else:
            rows, k = u_all[k:k + n], k + n
        out[ch] = torch.floor(rows.T * max_steps).to(torch.int32)
    return out


def num_offset_slots(progs) -> int:
    """The counter slots :func:`scheduled_offsets` takes from ``first_slot``
    on: every randomized offset but a single one on the dynamics channel."""
    n = {ch: prog.num_scheduled if prog is not None else 0 for ch, prog in progs.items()}
    return sum(n.values()) - (n.get("dynamics") == 1)
