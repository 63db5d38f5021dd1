"""Batched disturbance injection (impulse, step, uniform and white_noise kinds).

Port of ``safe_control_gym_tpu/envs/disturbances.py`` for the two
deterministic kinds (``disturbances.py:138-163``), ``uniform`` (:164-170,
:234-242) and ``white_noise`` (:171-175, :243-250).  A channel's YAML list
compiles to a ``CompiledDisturbances`` program, a function of the
per-episode offsets, the step counter and, for the noisy kinds, the env's
identity.  A randomized offset is drawn at reset from the counter PRNG
(``envs/quadrotor.py``), so it needs no carried random stream.

Noisy kinds: the JAX package draws them from a threefry key carried in the
env state, whose bits the port cannot reproduce.  The port draws them from
Philox (``ops/philox.py``) keyed on ``(env_seed, episode_idx)`` and counted
by ``(ctrl_step, entry, block, site)``, where ``entry`` is the entry's index
in the channel's list and ``site`` the channel's call site (action 1,
observation 2, dynamics 3): white noise is Box-Muller on each pair of
draws, uniform ``u * (high - low) + low`` on one draw a dim.  The noise is
then a pure function of the env's identity and step, with no generator to
carry, and the CPU and CUDA give the same stream.  It matches the JAX
package's in distribution only.  White noise on the dynamics channel is not
ported yet and raises, as do the other noisy kinds (periodic, brownian) and
state_dependent, when the env is built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from safe_control_gym_torch.ops import philox

# Call site (4th Philox counter word) of each channel's noisy kinds.
NOISE_SITES = {"action": philox.SITE_ACTION, "observation": philox.SITE_OBS,
               "dynamics": philox.SITE_DYNAMICS}
# The channels whose white noise is ported.
WHITE_NOISE_CHANNELS = ("action", "observation")


@dataclasses.dataclass(frozen=True)
class _Dist:
    kind: str  # impulse | step | uniform | white_noise
    dim: int
    mask: Optional[np.ndarray]
    magnitude: float = 1.0
    step_offset: Optional[int] = None  # None -> randomized per episode
    duration: int = 1
    decay_rate: float = 1.0
    std: Optional[np.ndarray] = None  # white noise, (dim,)
    low: Optional[np.ndarray] = None  # uniform, (dim,)
    high: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class CompiledDisturbances:
    """One channel's disturbance program."""

    dists: Sequence[_Dist]
    dim: int
    max_step: int  # EPISODE_LEN_SEC / CTRL_TIMESTEP (disturbances.py:112)
    site: Optional[int] = None  # the channel's Philox call site (noisy kinds)

    @property
    def num_scheduled(self) -> int:
        """Entries needing a per-episode sampled offset."""
        return sum(1 for d in self.dists
                   if d.kind in ("impulse", "step") and d.step_offset is None)

    def apply(self, offsets, ctrl_step, target, identity=None):
        """Apply all entries in order (disturbances.py:69-79).

        offsets: (B, num_scheduled) int32; ctrl_step: (B,) int32;
        target: (B, dim); identity: the envs' ``(env_seed, episode_idx)``
        int32 tensors, which key the noisy kinds."""
        dtype = target.dtype
        out = target
        si = 0
        for entry, d in enumerate(self.dists):
            if d.kind == "uniform":
                # uniform(sub, (dim,)) * (high - low) + low (disturbances.py:234-242).
                env_seed, episode_idx = identity
                u = philox.block_uniforms(ctrl_step, entry, self.site, env_seed, episode_idx,
                                          d.dim).T.to(dtype)
                lo = torch.as_tensor(d.low, dtype=dtype, device=target.device)
                hi = torch.as_tensor(d.high, dtype=dtype, device=target.device)
                noise = u * (hi - lo) + lo
                if d.mask is not None:
                    noise = noise * torch.as_tensor(d.mask, dtype=dtype, device=target.device)
                out = out + noise
                continue
            if d.kind == "white_noise":
                # jax.random.normal(sub, (dim,)) * std (disturbances.py:171-175).
                env_seed, episode_idx = identity
                u = philox.block_uniforms(ctrl_step, entry, self.site, env_seed, episode_idx,
                                          2 * d.dim)
                std = torch.as_tensor(d.std, dtype=dtype, device=target.device)
                noise = philox.box_muller(u, d.dim).T.to(dtype) * std
                if d.mask is not None:
                    noise = noise * torch.as_tensor(d.mask, dtype=dtype, device=target.device)
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
                    torch.pow(torch.tensor(d.decay_rate, dtype=dtype,
                                           device=target.device), peak_offset),
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
                noise = noise * torch.as_tensor(d.mask, dtype=dtype, device=target.device)
            out = out + noise
        return out


def build_disturbances(
    specs: Optional[Sequence[dict]],
    dim: int,
    episode_len_sec: float,
    ctrl_freq: int,
    channel: Optional[str] = None,
) -> Optional[CompiledDisturbances]:
    """Compile one channel's YAML spec list (reference
    create_disturbance_list, disturbances.py:315-333); ``channel`` names
    the channel (observation, action or dynamics), whose call site keys
    its white noise."""
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
        elif kind == "uniform" and channel in NOISE_SITES:
            d = _Dist(kind="uniform", dim=dim, mask=mask,
                      low=np.broadcast_to(np.asarray(spec.get("low", 0.0), float), (dim,)).copy(),
                      high=np.broadcast_to(np.asarray(spec.get("high", 1.0), float), (dim,)).copy())
        elif kind == "white_noise" and channel in WHITE_NOISE_CHANNELS:
            d = _Dist(kind="white_noise", dim=dim, mask=mask, std=np.broadcast_to(
                np.asarray(spec.get("std", 1.0), float), (dim,)).copy())
        else:
            raise NotImplementedError(
                f"disturbance_func {kind!r} on the {channel} channel is not ported yet "
                "(impulse, step and uniform, and white_noise on the action and observation "
                "channels)")
        dists.append(d)
    return CompiledDisturbances(
        dists=tuple(dists), dim=dim, max_step=int(episode_len_sec * ctrl_freq),
        site=NOISE_SITES.get(channel))
