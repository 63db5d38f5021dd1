"""Env families, one file each, found by the name a configuration gives.

A configuration's ``family`` names ``portbench/families/<family>.py``, which
holds the family's plain env step (part of the reference: plain PyTorch, no
import of the program or of JAX) and its counts for the yardstick:

* ``FIELDS``: the configuration's ``env`` fields the file implements;
* ``DIMS`` (observation and action widths), ``N_INERTIAL`` (the inertial
  values a draw makes ahead of the state), ``N_SLOTS`` (uniforms a draw
  takes), ``STATE_ROWS`` (rows a policy kernel reads and writes per env in
  the program's layout), ``STEP_OPS`` (operations of one control step,
  counted by hand from the equations);
* ``NOMINAL`` and ``params(env)``: the nominal inertia and the step's
  constants, raising for what the file does not implement;
* ``action_map(p, a)``, ``goal_rows(p, step_f)`` and
  ``advance(p, s, inert, thrust)``: the state after one control step, the
  action cost, the out-of-bound tests ``(value, low, high)`` and the rows
  that stayed finite (None where every row does).

A new family, or a task that an existing file does not implement, is a new
file; it may import the pieces of another.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

DIR = Path(__file__).resolve().parent


def load(name: str):
    """The module of family ``name``."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"no env family {name!r}")
    key = f"{__name__}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = DIR / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no env family {name!r} (no file {path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod
