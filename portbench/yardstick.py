"""The yardstick: the card's peaks and the work each measured piece needs.

Operations and bytes are counted from shapes, by hand from the upstream
equations and the CUDA sources as written, and kept here so that no later
change to the program can move them.  Each transcendental counts as one
operation and each count leaves out work a kernel may do beyond what these
inputs need (statistics it keeps for no reader, a branch the configuration
never takes), so that a time over these counts is a lower bound and a share
of a roofline or a peak cannot pass 100% unless the time misses work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3.
PEAK_F32_OPS_S = 67e12
PEAK_BYTES_S = 3.35e12

# What a family's env step needs (``STEP_OPS``) and the rows its policy
# kernel reads and writes per env (``STATE_ROWS``) are counted in the
# family's own file, ``portbench/families/<family>.py``.


def mlp_macs(nx: int, nu: int, h: int) -> int:
    """Multiply-adds of one forward pass of both networks on one sample."""
    return 2 * (nx * h + h * h) + h * (nu + 1)


def policy_ops(nx: int, nu: int, h: int) -> int:
    """Operations of the policy on one env-step: both networks' products
    and biases and the activations of the four hidden layers, one Philox
    block per two actions (10 rounds of 9), Box-Muller, the log-probability
    and the action map (~24 an action)."""
    blocks = (2 * nu + 3) // 4
    return 2 * mlp_macs(nx, nu, h) + 4 * h + (nu + 1) + 4 * h + blocks * 90 + 24 * nu


def policy_call(step_ops: int, state_rows: int, nx: int, nu: int, h: int, B: int, T: int):
    """(operations, bytes) of one policy-kernel call: T steps of B envs of
    ``step_ops`` operations an env step, ``state_rows`` rows an env read and
    written once, the packed weights read once, the record (T, 2 nx + nu +
    5, B) written once."""
    ops = B * T * (step_ops + policy_ops(nx, nu, h))
    n_w = 2 * h * nx + 2 * h + 4 * h * h + 2 * h + 8 * 2 * h + 8 + nu
    nbytes = 4 * (2 * B * state_rows + n_w + T * (2 * nx + nu + 5) * B)
    return ops, nbytes


def update_ops_per_sample(nx: int, nu: int, h: int) -> int:
    """Operations of one sample in K4, as its source computes them: both
    networks' forward (products, biases, tanh), the backward into both
    hidden layers, one multiply-add a sample into every weight gradient and
    an add into every bias gradient, and the losses (~66)."""
    fwd = 2 * (2 * (nx * h + h * h) + (nu + 1) * h) + 2 * h * 2 + (nu + 1) + 2 * 2 * h
    bwd = 2 * (nu + 1) * h + 2 * (2 * h * h) + 2 * 2 * h * 3
    acc = 2 * (2 * (nx * h + h * h) + (nu + 1) * h) + (4 * h + nu + 1 + nu + 3)
    return fwd + bwd + acc + 66


def n_params(nx: int, nu: int, h: int) -> int:
    return 2 * (h * nx + h + h * h + h) + (nu + 1) * h + nu + 1 + nu


def update_call(nx: int, nu: int, h: int, n: int):
    """(operations, bytes) of one K4 launch on a minibatch of n samples: the
    minibatch read once, the weights read and gradients and loss sums
    written once."""
    nbytes = 4 * ((nx + nu + 4) * n + 2 * n_params(nx, nu, h) + 3)
    return n * update_ops_per_sample(nx, nu, h), nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_OPS_S, nbytes / PEAK_BYTES_S)


def model_ops_rollout(step_ops: int, nx: int, nu: int, h: int, env_steps: int) -> float:
    """What a rollout needs, whatever computes it: the env's control step
    (``step_ops``) and one forward pass of both networks an env-step."""
    return env_steps * (step_ops + 2 * mlp_macs(nx, nu, h) + 8 * h)


def model_ops_train_step(step_ops: int, nx: int, nu: int, h: int, B: int, T: int,
                         epochs: int, n_mini: int) -> float:
    """What a PPO train step needs, whatever computes it: the rollout, then
    per sample and epoch the forward and the backward of both networks (3x
    the forward's products), and ~10 operations a parameter for each of
    the ``epochs * n_mini`` Adam steps."""
    n = B * T
    update = epochs * n * 3 * 2 * mlp_macs(nx, nu, h)
    return (model_ops_rollout(step_ops, nx, nu, h, n) + update
            + epochs * n_mini * 10 * n_params(nx, nu, h))
