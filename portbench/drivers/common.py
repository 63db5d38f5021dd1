"""What the drivers share: the program's env from a configuration, and the
policy's weights made from the seed."""

from __future__ import annotations

import importlib
import math

import torch

from portbench.reference import policy

WEIGHT_SALT = 0x5EED  # the weights' generator is keyed apart from the program's own


def build_env(config: dict, device):
    """The program's env of a configuration's ``env`` group, made as its
    ``program.env`` group says: ``make(Config(**env), device=device)`` with
    ``Config`` and ``make`` the names ``config`` and ``make`` of the
    program's module ``module``."""
    spec = config["program"]["env"]
    mod = importlib.import_module(spec["module"])
    return getattr(mod, spec["make"])(getattr(mod, spec["config"])(**config["env"]),
                                      device=device)


def make_weights(seed: int, nx: int, nu: int, h: int, device) -> dict:
    """The actor-critic's weights from the seed, on the device, in one draw:
    normal weights scaled by gain / sqrt(fan-in) (sqrt 2 on the hidden
    layers, 0.01 on the actor's output, 1 on the critic's: the gains of
    upstream's orthogonal init), zero biases, log-std -0.5."""
    shapes = {"w1a": (h, nx), "w2a": (h, h), "w3a": (nu, h),
              "w1c": (h, nx), "w2c": (h, h), "w3c": (1, h)}
    gains = {"w1a": math.sqrt(2.0), "w2a": math.sqrt(2.0), "w3a": 0.01,
             "w1c": math.sqrt(2.0), "w2c": math.sqrt(2.0), "w3c": 1.0}
    gen = torch.Generator(device=device).manual_seed((seed ^ WEIGHT_SALT) & (2**63 - 1))
    total = sum(a * b for a, b in shapes.values())
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    w, o = {}, 0
    for k, (a, b) in shapes.items():
        w[k] = z[o:o + a * b].view(a, b) * (gains[k] / math.sqrt(b))
        w["b" + k[1:]] = torch.zeros(a, device=device)
        o += a * b
    w["logstd"] = torch.full((nu,), -0.5, device=device)
    return {k: w[k] for k in policy.LEAVES}


def program_leaves(ac):
    """The program's ``ActorCritic`` parameters under the reference's names."""
    out = {}
    for net, tag in ((ac.actor, "a"), (ac.critic, "c")):
        for i, layer in enumerate(net.layers):
            out[f"w{i + 1}{tag}"] = layer.weight
            out[f"b{i + 1}{tag}"] = layer.bias
    out["logstd"] = ac.logstd
    return out


@torch.no_grad()
def load_weights(ac, w: dict) -> None:
    """Copy weights into the program's ``ActorCritic`` in place."""
    for k, p in program_leaves(ac).items():
        p.copy_(w[k])
