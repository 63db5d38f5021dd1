"""Small cells on the CPU for the benchmark's tests: the program runs its
kernels' plain versions there."""

from __future__ import annotations

import time

import torch

from portbench import harness

SMALL = {"train": {"num_envs": 32, "rollout_steps": 16, "cpu_units": 2},
         "collect": {"num_envs": 32, "rollout_steps": 40, "sample_range": 2, "cpu_units": 3}}
SEED = 2**31 + 977  # past 32 signed bits, as the driver's seeds are


def small_cell(name: str, root=harness.ROOT):
    cell = harness.resolve(name, root)
    cell.traffic.update(SMALL[cell.traffic["driver"]])
    return cell


def run_small(name: str, seed: int = SEED, root=harness.ROOT):
    """(correct, numbers) of a small CPU run of cell ``name``."""
    res, numbers = harness.run_cell(small_cell(name, root), seed, 1.0, False,
                                    torch.device("cpu"), time.perf_counter())
    return res["correct"], numbers
