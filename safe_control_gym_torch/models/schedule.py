"""Parameter schedules.

Port of ``safe_control_gym_tpu/models/schedule.py`` (reference
math_and_models/schedule.py): ``value = schedule(step)``, a float32 0-dim
tensor on the device of ``step`` (the CPU for a Python number).
"""

from __future__ import annotations

import torch


def _device(step):
    return step.device if isinstance(step, torch.Tensor) else None


class ConstantSchedule:
    def __init__(self, val: float):
        self.val = val

    def __call__(self, step):
        return torch.full((), self.val, dtype=torch.float32, device=_device(step))


class LinearSchedule:
    """Linear interpolation from ``start`` to ``end`` over ``steps`` steps.

    A tensor step divides in float32 and a Python step in double, rounded
    to float32 once, as the JAX package's ``step / steps`` does."""

    def __init__(self, start: float, end: float, steps: int):
        self.start, self.end, self.steps = start, end, max(steps, 1)

    def __call__(self, step):
        frac = torch.as_tensor(step / self.steps, dtype=torch.float32, device=_device(step))
        return self.start + torch.clamp(frac, 0.0, 1.0) * (self.end - self.start)
