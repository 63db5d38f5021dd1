"""The port's native runtime: ``scg_native.cpp`` through ctypes.

An independent float64 RK4 oracle for CartPole and the 3D quadrotor (the
PWM actuation map, then the rigid body), and a high-rate flight-log ring
buffer with a CSV flush.

This is the one entry point of the port that runs on the host by design,
whatever device its inputs lie on.  The JAX package's ``native/`` is host
C++ too, and an oracle earns its place by being independent of the device
path it checks: this one shares no code with the CUDA kernels (``csrc/``)
or their plain PyTorch versions.  Inputs may be numpy arrays or torch
tensors on any device; each is copied explicitly to a contiguous float64
host buffer.  Results are float64 numpy arrays: ``(T+1, 4)`` for CartPole,
``(T+1, 12)`` for the 3D quadrotor.

The library is built with ``g++`` at first use (never at import) into
``native/build/``: under an exclusive ``flock`` on ``build/build.lock``, so
that processes starting together build it once, into a temporary file that
is then moved into place; again whenever the source is newer than the
library.  Where no toolchain can build it, the entry points fall back to
the NumPy versions in ``_fallback`` (the same float64 semantics) with a
``RuntimeWarning``, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

from safe_control_gym_torch.native import _fallback
from safe_control_gym_torch.native._fallback import as_host_f64

SRC = Path(__file__).resolve().parent / "scg_native.cpp"
BUILD = Path(__file__).resolve().parent / "build"
LIB = BUILD / "libscg_native.so"

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _compiler():
    # -march=native is opt-in (SCG_NATIVE_MARCH=1): the library is then not
    # portable across machines that share the build directory.
    flags = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
    if os.environ.get("SCG_NATIVE_MARCH") == "1":
        flags.insert(2, "-march=native")
    return flags


def _current() -> bool:
    return LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime


def build(force: bool = False) -> Path:
    """Compile ``scg_native.cpp`` into ``LIB`` unless it is current (no
    older than the source); returns its path.  The compile runs under an
    exclusive ``flock``, and the library's freshness is looked at again
    once the lock is held: of the processes that start together, one
    compiles and the others find its library.  The lock goes with its
    holder's file descriptor, so a process that dies leaves none behind."""
    BUILD.mkdir(parents=True, exist_ok=True)
    if not force and _current():
        return LIB
    with open(BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _current():
            return LIB
        tmp = BUILD / f"{LIB.name}.{os.getpid()}.tmp"
        try:
            subprocess.check_call([*_compiler(), str(SRC), "-o", str(tmp)])
            os.replace(tmp, LIB)
        finally:
            tmp.unlink(missing_ok=True)
    return LIB


def available() -> bool:
    """True if the native library is loadable (builds it on first call)."""
    return _try_load() is not None


def _try_load():
    """Build and load the library; None (with a one-time RuntimeWarning)
    where no working C++ toolchain is present: callers then take the NumPy
    versions in ``_fallback``."""
    global _lib_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            return None
        try:
            return _load_locked()
        except (OSError, subprocess.CalledProcessError) as e:
            _lib_failed = True
            warnings.warn(
                "safe_control_gym_torch.native: C++ toolchain unavailable "
                f"({type(e).__name__}: {e}); using the NumPy fallback "
                "implementations (slower, same semantics).",
                RuntimeWarning,
                stacklevel=3,
            )
            return None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library; returns the ctypes
    CDLL.  Raises where the toolchain is missing: ``available`` is the soft
    test."""
    with _lock:
        if _lib is not None:
            return _lib
        return _load_locked()


def _load_locked() -> ctypes.CDLL:
    global _lib
    lib = ctypes.CDLL(str(build()))
    d = ctypes.POINTER(ctypes.c_double)
    i64, h = ctypes.c_int64, ctypes.c_void_p
    signatures = {
        # x0, forces, T, n_sub, dt, pole_length, pole_mass, cart_mass, out
        "scg_cartpole_rollout": ([d, d, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_double, ctypes.c_double, d], None),
        # x0, thrusts, T, n_sub, dt, mass, j, out
        "scg_quad3d_rollout": ([d, d, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                ctypes.c_double, d, d], None),
        "scg_thrust_to_forces": ([d, ctypes.c_int, d], None),
        "scg_logger_create": ([i64, i64], h),
        "scg_logger_destroy": ([h], None),
        "scg_logger_append": ([h, d, i64], None),
        "scg_logger_count": ([h], i64),
        "scg_logger_snapshot": ([h, d], i64),
        "scg_logger_flush_csv": ([h, ctypes.c_char_p, ctypes.c_char_p], ctypes.c_int),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _lib = lib
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def cartpole_rollout(x0, forces, dt, n_sub, pole_length, pole_mass, cart_mass):
    """CartPole from ``x0`` (4,) under ``forces`` (T,) or (T, 1), ``n_sub``
    RK4 substeps of ``dt`` a step: the states (T+1, 4), float64."""
    x0 = as_host_f64(x0).reshape(4)
    forces = as_host_f64(forces).reshape(-1)
    lib = _try_load()
    if lib is None:
        return _fallback.cartpole_rollout(x0, forces, dt, n_sub, pole_length, pole_mass,
                                          cart_mass)
    T = forces.shape[0]
    out = np.empty((T + 1, 4), np.float64)
    lib.scg_cartpole_rollout(_ptr(x0), _ptr(forces), T, n_sub, dt, pole_length, pole_mass,
                             cart_mass, _ptr(out))
    return out


def quad3d_rollout(x0, thrusts, dt, n_sub, mass, j_diag):
    """The 3D quadrotor from ``x0`` (12,) under commanded per-motor
    ``thrusts`` (T, 4) through the PWM map, ``n_sub`` RK4 substeps of
    ``dt`` a step, mass ``mass`` and inertia diagonal ``j_diag`` (3,): the
    states (T+1, 12), float64."""
    x0 = as_host_f64(x0).reshape(12)
    thrusts = as_host_f64(thrusts).reshape(-1, 4)
    j = as_host_f64(j_diag).reshape(3)
    lib = _try_load()
    if lib is None:
        return _fallback.quad3d_rollout(x0, thrusts, dt, n_sub, mass, j)
    T = thrusts.shape[0]
    out = np.empty((T + 1, 12), np.float64)
    lib.scg_quad3d_rollout(_ptr(x0), _ptr(thrusts), T, n_sub, dt, mass, _ptr(j), _ptr(out))
    return out


class NativeFlightLogger:
    """High-rate telemetry ring buffer (``scg_native.cpp``): keeps the last
    ``capacity`` records of ``width`` float64 values; a ``_fallback.
    PyFlightLogger`` where the library is unavailable."""

    def __new__(cls, capacity: int, width: int, header: str = ""):
        if _try_load() is None:
            return _fallback.PyFlightLogger(capacity, width, header)
        return super().__new__(cls)

    def __init__(self, capacity: int, width: int, header: str = ""):
        if capacity < 1 or width < 1:
            raise ValueError(f"capacity and width must be positive: {capacity}, {width}")
        self._lib = load()
        self._h = ctypes.c_void_p(self._lib.scg_logger_create(capacity, width))
        self.width = int(width)
        self.capacity = int(capacity)
        self.header = header

    def append(self, records):
        """Append one record (width,) or a block of them (n, width)."""
        rec = as_host_f64(records).reshape(-1, self.width)
        self._lib.scg_logger_append(self._h, _ptr(rec), rec.shape[0])

    @property
    def count(self) -> int:
        """Records appended so far (may exceed the capacity)."""
        return int(self._lib.scg_logger_count(self._h))

    def snapshot(self):
        """The last min(count, capacity) records, oldest first."""
        n = min(self.count, self.capacity)
        out = np.empty((n, self.width), np.float64)
        if n:
            self._lib.scg_logger_snapshot(self._h, _ptr(out))
        return out

    def flush_csv(self, path):
        """Write the snapshot to ``path`` as CSV (``%.17g``: reads back
        exactly), under the header line if one was given."""
        if self._lib.scg_logger_flush_csv(self._h, os.fsencode(path), self.header.encode()) != 0:
            raise IOError(f"flush_csv failed: {path}")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.scg_logger_destroy(h)
