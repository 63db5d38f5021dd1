"""Layered configuration system.

Port of ``safe_control_gym_tpu/utils/configuration.py`` (the counterpart of
the reference's ConfigFactory, safe_control_gym/utils/configuration.py:
14-97): argparse base flags, then the merge precedence  restore-config OR
(algo default + task default)  <-  override YAMLs (recursive merge)  <-
``config_override``  <-  "a.b.c=value" deep-set overrides.  Returns an
attribute-accessible dict (the reference's munch).
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Any, Optional

import yaml

from safe_control_gym_torch.utils.registration import get_config


class AttrDict(dict):
    """Attribute-style access (replaces munch)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return AttrDict(v) if isinstance(v, dict) and not isinstance(v, AttrDict) else v

    def __setattr__(self, k, v):
        self[k] = v


def merge_dict(base: dict, override: dict) -> dict:
    """Recursive dict merge (reference utils.py:70-79)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dict(out[k], v)
        else:
            out[k] = v
    return out


def deep_set(d: dict, dotted_key: str, value: Any):
    """Deep-set 'a.b.c' = value (reference configuration.py:83-92)."""
    keys = dotted_key.split(".")
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = yaml.safe_load(str(value))


class ConfigFactory:
    """Build the merged run config (reference configuration.py:14-97)."""

    def __init__(self):
        self.parser = argparse.ArgumentParser(description="safe-control-gym-torch")
        self.add_argument("--tag", type=str, default="temp")
        self.add_argument("--seed", type=int, default=None)
        self.add_argument("--device", type=str, default=None)
        self.add_argument("--output_dir", type=str, default="results")
        self.add_argument("--restore", type=str, default=None)
        self.add_argument("--algo", type=str, default=None)
        self.add_argument("--task", type=str, default=None)
        self.add_argument("--overrides", nargs="+", type=str, default=[])
        self.add_argument("--kv_overrides", nargs="+", type=str, default=[])

    def add_argument(self, *args, **kwargs):
        self.parser.add_argument(*args, **kwargs)

    def merge(self, args: Optional[list] = None,
              config_override: Optional[dict] = None) -> AttrDict:
        cli, _ = self.parser.parse_known_args(args)
        config = {"tag": cli.tag, "seed": cli.seed, "output_dir": cli.output_dir}
        if cli.restore:
            # Restore a saved run config (configuration.py:67-70).
            with open(os.path.join(cli.restore, "config.yaml")) as f:
                config = merge_dict(config, yaml.safe_load(f))
        else:
            if cli.algo:
                config["algo"] = cli.algo
                config["algo_config"] = get_config(cli.algo)
            if cli.task:
                config["task"] = cli.task
                config["task_config"] = get_config(cli.task)
        for path in cli.overrides:
            with open(path) as f:
                config = merge_dict(config, yaml.safe_load(f))
        if config_override:
            config = merge_dict(config, config_override)
        for kv in cli.kv_overrides:
            k, v = kv.split("=", 1)
            v = v.strip()
            try:
                # Typed literals ('1e-3' -> float, 'True' -> bool, lists) as
                # the reference's eval (configuration.py:86-90), data only.
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass  # a plain string
            deep_set(config, k.strip(), v)
        return AttrDict(config)


def save_config(config: dict, output_dir: str):
    """Write the config's provenance (reference utils.py:124-149)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(dict(config), f)
