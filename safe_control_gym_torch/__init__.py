"""PyTorch/CUDA port of safe-control-gym-tpu.

The package mirrors the JAX package's tree (``ops/``, ``envs/``,
``parallel/``, ``utils/``).  Environments are plain functions on batched
``(B, ...)`` tensors; the hot loops run in hand-written CUDA kernels for
Hopper (``csrc/``, built and loaded by ``kernels/``), each with a plain
PyTorch version beside it that CPU tensors take.

Entry points (``make_quadrotor``, ``make_vec_env``, ``FastQuadRollout``) run
on ``torch.device("cuda")`` unless the caller passes ``device="cpu"``.
"""
