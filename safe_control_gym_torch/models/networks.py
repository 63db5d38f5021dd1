"""Neural network building blocks.

Port of ``safe_control_gym_tpu/models/networks.py`` (flax): the MLP with
activation by name and orthogonal init (reference
neural_networks.py:26-68), the Nature-DQN CNN (:71-106) and the GRU RNN
with done masks (:109-168).  Each module keeps the flax module's parameter
layout (``MLP.layers[i]`` is ``Dense_i``, the CNN's ``convs[i]`` is
``Conv_i``, the RNN's gates are the flax ``GRUCell``'s); ``utils/convert.py``
carries weights across, so the tests never rely on the init.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

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


# The CNN's conv stack (reference neural_networks.py:71-106): (features,
# kernel, stride).
CNN_CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding of one spatial dim: ceil(size / stride) outputs,
    the total padding split with the smaller half first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class CNN(nn.Module):
    """Nature-DQN conv stack on (B, H, W, C) images, as flax's: each conv
    pads 'SAME' as XLA does (``torch.nn.Conv2d`` takes no 'same' with a
    stride, so the pads are explicit), and the features flatten in NHWC
    order before ``Dense(512)``.  ``input_shape`` is (H, W, C)."""

    def __init__(self, input_shape: Sequence[int], output_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        h, w, c = input_shape
        self.pads = []
        convs = []
        for features, k, stride in CNN_CONVS:
            (top, bottom), (left, right) = _same_pads(h, k, stride), _same_pads(w, k, stride)
            self.pads.append((left, right, top, bottom))
            convs.append(nn.Conv2d(c, features, k, stride=stride))
            h, w, c = -(-h // stride), -(-w // stride), features
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(h * w * c, 512)
        self.out = nn.Linear(512, output_dim)
        for layer in [*self.convs, self.dense, self.out]:
            nn.init.orthogonal_(layer.weight, gain=math.sqrt(2.0), generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv, pads in zip(self.convs, self.pads):
            x = F.relu(conv(F.pad(x, pads)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.out(F.relu(self.dense(x)))


class GRUCell(nn.Module):
    """flax's ``GRUCell`` with its parameters: biases on the input
    projections and on the candidate's recurrent projection only,

        r = sigmoid(x W_ir + b_ir + h W_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz)
        n = tanh(x W_in + b_in + r (h W_hn + b_hn))
        h' = (1 - z) n + z h

    The input projections are one Linear (gates r, z, n) and the recurrent
    projections of r and z another; ``torch.nn.GRUCell`` would add the two
    redundant biases b_hr and b_hz."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.inp = nn.Linear(input_dim, 3 * hidden_dim)
        self.h_rz = nn.Linear(hidden_dim, 2 * hidden_dim, bias=False)
        self.h_n = nn.Linear(hidden_dim, hidden_dim)
        # flax: lecun_normal input kernels, orthogonal recurrent kernels,
        # zero biases.
        std = 1.0 / math.sqrt(input_dim) / 0.87962566103423978
        nn.init.trunc_normal_(self.inp.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        for w in (self.h_rz.weight[:hidden_dim], self.h_rz.weight[hidden_dim:], self.h_n.weight):
            with torch.no_grad():
                w.copy_(nn.init.orthogonal_(torch.empty_like(w), generator=generator))
        nn.init.zeros_(self.inp.bias)
        nn.init.zeros_(self.h_n.bias)

    def forward(self, h, x):
        xr, xz, xn = self.inp(x).chunk(3, -1)
        hr, hz = self.h_rz(h).chunk(2, -1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * self.h_n(h))
        return (1.0 - z) * n + z * h


class RNN(nn.Module):
    """GRU over (B, T, D) sequences with done masks (reference
    neural_networks.py:109-168): before step t the carry is multiplied by
    ``masks[:, t]``, so a 0 starts a new segment.  Returns (outputs
    (B, T, H), final carry (B, H))."""

    def __init__(self, input_dim: int, hidden_dim: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell = GRUCell(input_dim, hidden_dim, generator=generator)

    def forward(self, xs, masks=None, init_carry=None):
        B, T = xs.shape[:2]
        h = xs.new_zeros(B, self.hidden_dim) if init_carry is None else init_carry
        ys = []
        for t in range(T):
            if masks is not None:
                h = h * masks[:, t, None]
            h = self.cell(h, xs[:, t])
            ys.append(h)
        return torch.stack(ys, 1), h
