"""Global registry of environments and controllers.

Port of ``safe_control_gym_tpu/utils/registration.py`` (the counterpart of
the reference's entry-point registry, safe_control_gym/utils/
registration.py:15-167): ``register(id, entry_point, config_entry_point)``,
``make(id, *args, **kwargs)`` and ``get_config(id)`` on a module-level
singleton.  Entry points are "module:attr" strings or callables; configs
are dicts or YAML paths ("package.module:relative/path.yaml" resolves
against the module's directory).
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Callable, Optional, Union


def load(name: Union[str, Callable]) -> Callable:
    """Resolve a "module:attr" entry point (reference registration.py:15-22)."""
    if callable(name):
        return name
    mod_name, attr_name = name.split(":")
    return getattr(importlib.import_module(mod_name), attr_name)


class Spec:
    """A registered entry (reference registration.py:25-86)."""

    def __init__(self, id: str, entry_point: Union[str, Callable],
                 config_entry_point: Optional[Union[str, dict]] = None):
        self.id = id
        self.entry_point = entry_point
        self.config_entry_point = config_entry_point

    def get_config(self) -> dict:
        if self.config_entry_point is None:
            return {}
        if isinstance(self.config_entry_point, dict):
            return copy.deepcopy(self.config_entry_point)
        path = self.config_entry_point
        if ":" in path and not os.path.exists(path):
            pkg, rel = path.split(":")
            path = os.path.join(os.path.dirname(importlib.import_module(pkg).__file__), rel)
        import yaml

        with open(path) as f:
            return yaml.safe_load(f)

    def make(self, *args, **kwargs):
        return load(self.entry_point)(*args, **kwargs)


class Registry:
    """Keeps track of registered ids (reference registration.py:89-141)."""

    def __init__(self):
        self.specs: dict[str, Spec] = {}

    def register(self, id: str, entry_point, config_entry_point=None):
        if id in self.specs:
            raise ValueError(f"Cannot re-register id: {id}")
        self.specs[id] = Spec(id, entry_point, config_entry_point)

    def make(self, id: str, *args, **kwargs):
        if id not in self.specs:
            raise KeyError(f"No registered id: {id}; known: {sorted(self.specs)}")
        return self.specs[id].make(*args, **kwargs)

    def get_config(self, id: str) -> dict:
        if id not in self.specs:
            raise KeyError(f"No registered id: {id}")
        return self.specs[id].get_config()

    def ids(self):
        return sorted(self.specs)


registry = Registry()


def register(id: str, entry_point, config_entry_point=None):
    """Register an env or controller factory (reference registration.py:144-152)."""
    registry.register(id, entry_point, config_entry_point)


def make(id: str, *args, **kwargs) -> Any:
    """Instantiate a registered id (reference registration.py:155-161)."""
    return registry.make(id, *args, **kwargs)


def get_config(id: str) -> dict:
    """The default config of a registered id (reference registration.py:164-167)."""
    return registry.get_config(id)
