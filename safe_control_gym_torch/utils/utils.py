"""Misc utilities.

Port of ``safe_control_gym_tpu/utils/utils.py`` (reference
safe_control_gym/utils/utils.py).  The JAX package keys its device
randomness and so seeds only the host's generators; the port also seeds
and snapshots torch's global generators, the CPU's and, where a card is
present, the CUDA ones (the reference's utils.py:91-108 does the same).
"""

from __future__ import annotations

import datetime
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch
import yaml

from safe_control_gym_torch.utils.configuration import merge_dict  # noqa: F401 (public name)


def read_file(path: str):
    """Load json/yaml/txt by extension (reference utils.py:41-67)."""
    ext = os.path.splitext(path)[1]
    with open(path) as f:
        if ext == ".json":
            return json.load(f)
        if ext in (".yaml", ".yml"):
            return yaml.safe_load(f)
        return f.read()


def set_seed(seed: int):
    """Seed Python's, NumPy's and torch's global generators (torch's seeds
    every CUDA device's too).  The learners draw from generators of their
    own, seeded by their ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_random_state():
    """Snapshot of the global generators (reference utils.py:91-99)."""
    state = {"random": random.getstate(), "numpy": np.random.get_state(),
             "torch": torch.get_rng_state()}
    if torch.cuda.is_available():
        state["cuda"] = torch.cuda.get_rng_state_all()
    return state


def set_random_state(state: dict):
    random.setstate(state["random"])
    np.random.set_state(state["numpy"])
    torch.set_rng_state(state["torch"])
    if "cuda" in state:
        torch.cuda.set_rng_state_all(state["cuda"])


def set_dir_from_config(config) -> str:
    """Make results/{tag}/seed{N}_{timestamp}_{git hash}/ with the config
    and the command line in it (reference utils.py:124-149); the config's
    ``output_dir`` becomes that directory."""
    ts = datetime.datetime.now().strftime("%m.%d-%H.%M.%S")
    seed = config.get("seed", 0)
    try:
        git_hash = subprocess.check_output(["git", "rev-parse", "--short", "HEAD"],
                                           stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        git_hash = "nogit"
    run_dir = os.path.join(config.get("output_dir", "results"), str(config.get("tag", "temp")),
                           f"seed{seed}_{ts}_{git_hash}")
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(dict(config), f)
    with open(os.path.join(run_dir, "cmd.txt"), "w") as f:
        f.write(" ".join(sys.argv))
    config["output_dir"] = run_dir
    return run_dir


class sync:
    """Real-time pacing (reference utils.py:223-238): ``sync(start,
    dt)(i)`` sleeps until step ``i`` is due."""

    def __init__(self, start_time: float, timestep: float):
        self.start = start_time
        self.dt = timestep

    def __call__(self, i: int):
        elapsed = time.time() - self.start
        target = i * self.dt
        if target > elapsed:
            time.sleep(target - elapsed)
