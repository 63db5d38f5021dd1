"""Checkpoint / resume of a whole training state.

Port of ``safe_control_gym_tpu/utils/checkpoint.py`` (reference ppo.py:106-155:
nets, optimizers, normalizers, total steps, obs and the full RNG state).
The JAX package's state is one PyTree whose PRNG keys are leaves; here a
learner's state is a graph of dataclasses, modules and optimizers whose
random state lives in ``torch.Generator``s beside it, so a checkpoint
saves the state together with the generators the caller hands in (e.g.
``(ppo.state, ppo.gen)``), and resuming from it continues bit for bit.

The payload is the JAX package's (``state``, ``step``, ``metadata``), pickled
and written atomically through a ``.tmp`` file.  Every tensor is saved as a
CPU copy and comes back on the device the caller names (its own where
None); a parameter stays a parameter, and an object referenced twice (a
module's parameter in its optimizer's list) comes back as one object.  A
generator is saved by its ``get_state()`` and its device: a CPU generator
comes back on the CPU, a device generator on the named device.  Load only
files this module wrote: unpickling runs code.
"""

from __future__ import annotations

import functools
import io
import os
import pickle

import numpy as np
import torch


def _rebuild_tensor(array, requires_grad, parameter, device_str, device=None):
    t = torch.from_numpy(array).to(device if device is not None else device_str)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad)


def _rebuild_generator(state, device_str, device=None):
    dev = torch.device(device_str)
    if dev.type != "cpu" and device is not None:
        dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.set_state(torch.from_numpy(state))
    return gen


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            array = obj.detach().cpu().numpy().copy()
            return _rebuild_tensor, (array, obj.requires_grad,
                                     isinstance(obj, torch.nn.Parameter), str(obj.device))
        if isinstance(obj, torch.Generator):
            return _rebuild_generator, (obj.get_state().numpy().copy(), str(obj.device))
        return NotImplemented


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, device):
        super().__init__(f)
        self.device = device

    def find_class(self, module, name):
        if module == __name__ and name in ("_rebuild_tensor", "_rebuild_generator"):
            return functools.partial(globals()[name], device=self.device)
        return super().find_class(module, name)


def save_checkpoint(path: str, state, step: int | None = None, metadata: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"state": state, "step": step, "metadata": metadata or {}}
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load_checkpoint(path: str, device=None):
    """(state, step, metadata) of a checkpoint, its tensors and device
    generators on ``device`` (where they were saved from, if None)."""
    with open(path, "rb") as f:
        payload = _Unpickler(f, device).load()
    return payload["state"], payload["step"], payload["metadata"]


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt_"):
    """The file of ``ckpt_dir`` named ``<prefix><n>...`` with the largest n,
    or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir) if f.startswith(prefix)]
    if not cands:
        return None
    return os.path.join(ckpt_dir, max(cands, key=lambda f: int(f[len(prefix):].split(".")[0])))
