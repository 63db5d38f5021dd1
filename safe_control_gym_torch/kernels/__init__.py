"""Build and load the port's CUDA kernels (``csrc/``) through ctypes.

The kernels are plain-C entry points compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``kernels/build/libscg_kernels.so`` at first use, from the
sources in ``csrc/`` only.  Each source compiles in its own ``nvcc`` process,
all started together, and one more call links the shared library.  A stamp
of the sources and flags skips the build when nothing changed.  Nothing here
runs at import: the CPU tests import every module and have no ``nvcc``.

Every entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
LIB = BUILD / "libscg_kernels.so"
SOURCES = ("quad3d_substeps.cu", "quad3d_rollout.cu", "quad3d_policy_rollout.cu", "ppo_update.cu",
           "minibatch_layout.cu", "cartpole_rollout.cu", "cartpole_policy_rollout.cu",
           "quad_planar_rollout.cu", "quad_planar_policy_rollout.cu")
# -fmad=false: no contraction of a*b+c into FMA, so the kernels round like
# their plain PyTorch versions (one rounding per op) and done flags at the
# bounds do not flip between the two.  K4 alone asks for FMA in its
# products with __fmaf_rn (csrc/ppo_update.cu).  Never --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    # x, thrust, ext, mass, j, out, B, dt, dt_half, dt_sixth, n_sub, euler,
    # g, l_sq2, km_over_kf, actuation, then the launch plan
    # (quad_substeps.launch_plan: group, block, grid), stream
    "quad3d_substeps": [_P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _I, _I,
                        _F, _F, _F, _I, _I, _I, _I, _P],
    # the same in float64: the scalars are doubles
    "quad3d_substeps_f64": [_P, _P, _P, _P, _P, _P, _I, _D, _D, _D, _I, _I,
                            _D, _D, _D, _I, _I, _I, _I, _P],
    "quad3d_substeps_api_version": [],
    # params (host struct pointer), seed, rows_in, action, rows_out, B, then
    # the launch plan (fast_env.launch_plan: group, block, grid), stream
    "quad3d_rollout": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "quad3d_rollout_params_size": [],
    "quad3d_rollout_api_version": [],
    # params, normalized, relu, norm_act_scale, hover_thrust, hidden, seed,
    # wflat, rows_in, rows_out, traj, B, then the launch plan
    # (fast_policy.launch_plan: group, block, grid, smem bytes), stream
    "quad3d_policy_rollout": [_P, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the observation instance: params, ObsExt (fast_policy.ObsExtParams),
    # then the arguments of quad3d_policy_rollout after its params
    "quad3d_policy_rollout_obs": [_P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _P],
    # the maze instances: params, ObsExt or null (the state observation),
    # then the arguments of quad3d_policy_rollout after its params
    "quad3d_policy_rollout_maze": [_P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _P],
    "quad3d_policy_rollout_api_version": [],
    "obs_ext_params_size": [],
    # nx, nu, H, mb, plan (int[8], written)
    "ppo_grads_plan": [_I, _I, _I, _I, _P],
    # plan, nx, nu, H, mb, relu, clip_lo, clip_hi, inv_n, mb_ptr, wflat, wpad,
    # partial, out, stream
    "ppo_grads": [_P, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P, _P],
    "ppo_grads_api_version": [],
    # packed, idx, idx row stride, out, N, F, n_mini, m, stream
    "minibatch_layout": [_P, _P, ctypes.c_int64, _P, ctypes.c_int64, _I, _I, _I, _P],
    # params, seed, rows_in, action, rows_out, B, then the launch plan
    # (fast_cartpole.launch_plan: group, block, grid), stream
    "cartpole_rollout": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cartpole_rollout_api_version": [],
    "cartpole_params_size": [],
    # params, relu, hidden, seed, wflat, rows_in, rows_out, traj, B, then the
    # launch plan (fast_cartpole.policy_launch_plan: group, block, grid, smem
    # bytes), stream
    "cartpole_policy_rollout": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the observation instance: params, ObsExt, then the same arguments
    "cartpole_policy_rollout_obs": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cartpole_policy_rollout_api_version": [],
    # params, nx, seed, rows_in, action, rows_out, B, then the launch plan
    # (fast_quad_planar.launch_plan: group, block, grid), stream
    "quad_planar_rollout": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "quad_planar_rollout_api_version": [],
    "quad_planar_params_size": [],
    # params, nx, relu, hidden, seed, wflat, rows_in, rows_out, traj, B, then
    # the launch plan (fast_quad_planar.policy_launch_plan), stream
    "quad_planar_policy_rollout": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the observation instances: params, ObsExt, then the same arguments
    "quad_planar_policy_rollout_obs": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _P],
    "quad_planar_policy_rollout_api_version": [],
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _stamp() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _current(stamp: str) -> bool:
    stamp_file = BUILD / "stamp"
    return LIB.exists() and stamp_file.exists() and stamp_file.read_text() == stamp


def build(force: bool = False) -> Path:
    """Compile ``csrc/`` into the shared library unless it is current.
    The compiler's register and spill report goes to ``build/ptxas.log``.

    Processes that start together (the ranks of a cluster on one card)
    build under an exclusive ``flock`` on ``build/build.lock`` and look at
    the stamp again once they hold it: one of them compiles, the others load
    its library.  The lock goes with its holder's file descriptor, so a
    process that dies leaves none behind."""
    BUILD.mkdir(parents=True, exist_ok=True)
    stamp = _stamp()
    if not force and _current(stamp):
        return LIB
    with open(BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _current(stamp):
            return LIB
        return _compile(stamp)


def _compile(stamp: str) -> Path:
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = BUILD / (Path(src).stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    (BUILD / "ptxas.log").write_text("\n".join(logs))
    tmp = BUILD / f"{LIB.name}.{os.getpid()}.tmp"
    objs = [str(BUILD / (Path(s).stem + ".o")) for s in SOURCES]
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIB)
    (BUILD / "stamp").write_text(stamp)
    return LIB


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
