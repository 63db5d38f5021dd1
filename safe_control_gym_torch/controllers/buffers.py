"""Device-resident replay buffer.

Port of ``safe_control_gym_tpu/controllers/buffers.py`` (reference
sac_utils.py:294-412): a fixed-capacity ring of tensors on the learner's
device, pushed to and sampled from inside a train step.  The pointer and
the fill level are host ints: push sizes are static, so both are known on
the host, and neither a push nor a sample reads anything back from the
device.
"""

from __future__ import annotations

import torch


class ReplayBuffer:
    """``data``: name -> (capacity, ...) tensor, allocated once."""

    def __init__(self, capacity: int, specs: dict, dtype=torch.float32, device=None):
        """``specs``: name -> trailing shape tuple."""
        self.capacity = capacity
        self.data = {k: torch.zeros((capacity,) + tuple(shape), dtype=dtype, device=device)
                     for k, shape in specs.items()}
        self.ptr = 0
        self.size = 0

    def push(self, batch: dict):
        """Insert a (B, ...) batch at the ring pointer, wrapping."""
        B = next(iter(batch.values())).shape[0]
        if B > self.capacity:
            raise ValueError(f"a push of {B} rows into a ring of {self.capacity}")
        head = min(B, self.capacity - self.ptr)
        for k, v in batch.items():
            buf = self.data[k]
            buf[self.ptr:self.ptr + head] = v[:head]
            if head < B:
                buf[:B - head] = v[head:]
        self.ptr = (self.ptr + B) % self.capacity
        self.size = min(self.size + B, self.capacity)
        return self

    def sample(self, generator, batch_size: int, idx=None):
        """A uniform draw of ``batch_size`` rows from ``[0, max(size, 1))``;
        ``idx`` (int64, on the buffer's device) replaces the draw."""
        if idx is None:
            first = next(iter(self.data.values()))
            idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                                device=first.device)
        return {k: v[idx] for k, v in self.data.items()}
