"""Batched disturbance injection (impulse and step kinds).

Port of ``safe_control_gym_tpu/envs/disturbances.py`` for the two
deterministic kinds (``disturbances.py:138-163``).  A channel's YAML list
compiles to a ``CompiledDisturbances`` program, a function of the
per-episode offsets and the step counter.  A randomized offset is drawn at
reset from the counter PRNG (``envs/quadrotor.py``), so it needs no carried
random stream.  The kinds that draw step noise (uniform, white_noise,
periodic, brownian) and state_dependent raise ``NotImplementedError`` when
the env is built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class _Dist:
    kind: str  # impulse | step
    dim: int
    mask: Optional[np.ndarray]
    magnitude: float = 1.0
    step_offset: Optional[int] = None  # None -> randomized per episode
    duration: int = 1
    decay_rate: float = 1.0


@dataclasses.dataclass(frozen=True)
class CompiledDisturbances:
    """One channel's disturbance program."""

    dists: Sequence[_Dist]
    dim: int
    max_step: int  # EPISODE_LEN_SEC / CTRL_TIMESTEP (disturbances.py:112)

    @property
    def num_scheduled(self) -> int:
        """Entries needing a per-episode sampled offset."""
        return sum(1 for d in self.dists if d.step_offset is None)

    def apply(self, offsets, ctrl_step, target):
        """Apply all entries in order (disturbances.py:69-79).

        offsets: (B, num_scheduled) int32; ctrl_step: (B,) int32;
        target: (B, dim)."""
        dtype = target.dtype
        out = target
        si = 0
        for d in self.dists:
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
) -> Optional[CompiledDisturbances]:
    """Compile one channel's YAML spec list (reference
    create_disturbance_list, disturbances.py:315-333)."""
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
        else:
            raise NotImplementedError(
                f"disturbance_func {kind!r} is not ported yet (impulse and step only)")
        dists.append(d)
    return CompiledDisturbances(
        dists=tuple(dists), dim=dim, max_step=int(episode_len_sec * ctrl_freq))
