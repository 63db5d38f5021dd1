"""PyTorch/CUDA port of safe-control-gym-tpu.

The package mirrors the JAX package's tree (``ops/``, ``envs/``,
``parallel/``, ``utils/``).  Environments are plain functions on batched
``(B, ...)`` tensors; the hot loops run in hand-written CUDA kernels for
Hopper (``csrc/``, built and loaded by ``kernels/``), each with a plain
PyTorch version beside it that CPU tensors take.

Entry points (``make_quadrotor``, ``make_vec_env``, ``FastQuadRollout``) run
on ``torch.device("cuda")`` unless the caller passes ``device="cpu"``.
"""

from safe_control_gym_torch.utils.registration import get_config, make, register, registry

__version__ = "0.1.0"

__all__ = ["make", "register", "get_config", "registry", "__version__"]

# Register the built-in environments and controllers on import, as the JAX
# package does (reference: safe_control_gym/__init__.py,
# utils/registration.py:89-167).
from safe_control_gym_torch import _registry_entries  # noqa: E402,F401
