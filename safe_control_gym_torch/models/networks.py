"""Neural network building blocks.

Port of ``safe_control_gym_tpu/models/networks.py`` (flax) for the MLP:
activation by name and orthogonal init (reference
neural_networks.py:26-68).  ``MLP.layers[i]`` holds the flax module's
``Dense_i``; ``utils/convert.py`` carries weights across, so the tests never
rely on the init.  The CNN and the GRU RNN are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn
from torch.nn import functional as F

def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu defaults to the tanh approximation


def _identity(x):
    return x


# Module-level functions, so that a module holding one pickles.
ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "gelu": _gelu,
    "leaky_relu": F.leaky_relu,  # slope 0.01, as flax
    "identity": _identity,
}


def get_activation(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return ACTIVATIONS[name]


class MLP(nn.Module):
    """Multi-layer perceptron with orthogonal init (gain ``init_gain`` on the
    hidden layers, ``out_gain`` on the output layer) and zero biases.

    Unlike flax, the input width is given up front.  ``generator`` seeds the
    init (``torch.Generator`` on the CPU)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dims: Sequence[int] = (64, 64),
                 act: str = "relu", out_act: str = "identity",
                 init_gain: float = math.sqrt(2.0), out_gain: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.output_dim = output_dim
        self.act_name = act
        self.act = get_activation(act)
        self.out_act = get_activation(out_act)
        dims = [input_dim, *hidden_dims, output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        for i, layer in enumerate(self.layers):
            gain = out_gain if i == len(self.layers) - 1 else init_gain
            nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        return self.out_act(self.layers[-1](x))
