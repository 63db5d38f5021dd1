"""The port's native runtime (``safe_control_gym_torch/native/``) against the
JAX package's, the NumPy oracle and the port's own float64 engine, at the
sizes and tolerances of ``tests/test_native.py``: the C++ oracle's rollouts,
its NumPy fallback, the flight-log ring buffer, and the build under
processes that start together.

The JAX package's library is built into a temporary directory here (its
module's ``_LIB`` pointed there), so that nothing is written beside its
source while ``tests/test_native.py`` may build it in another worker."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from safe_control_gym_torch import native
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.native import _fallback
from safe_control_gym_tpu import native as jax_native

sys.path.insert(0, os.path.dirname(__file__))
from oracles import numpy_reference as np_oracle  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MASS, J_DIAG = 0.03454, np.array([1.4e-5, 1.4e-5, 2.17e-5])
HOVER = MASS * 9.8 / 4


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's ``native`` module, its library built with its own
    flags into a temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", str(tmp_path_factory.mktemp("jax_native") / "lib.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_lib_failed", False)
        jax_native.load()
        yield jax_native


def cartpole_case(seed=0, steps=50, n_sub=1):
    """tests/test_native.py's CartPole inputs: (x0, forces, dt, n_sub,
    pole_length, pole_mass, cart_mass)."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=4) * 0.1
    forces = rng.uniform(-5, 5, size=(steps, 1))
    return x0, forces, 0.02, n_sub, 1.0, 0.1, 1.0


def quad3d_case(seed=1, steps=40, n_sub=4, spread=0.03):
    """tests/test_native.py's 3D inputs from hover at z = 1: (x0, thrusts,
    dt, n_sub, mass, j_diag)."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros(12)
    x0[4] = 1.0
    thrusts = HOVER * (1 + spread * rng.standard_normal((steps, 4)))
    return x0, thrusts, 1 / 240, n_sub, MASS, J_DIAG


CASES = {"cartpole": (cartpole_case, "cartpole_rollout", (51, 4)),
         "quad3d": (quad3d_case, "quad3d_rollout", (41, 12))}


@pytest.mark.parametrize("system", sorted(CASES))
def test_rollouts_bit_equal_to_the_jax_packages_native(jax_lib, system):
    """The same source and flags give the same bits; the port takes torch
    tensors where the JAX package takes numpy arrays."""
    make, fn, shape = CASES[system]
    args = make()
    got = getattr(native, fn)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                for a in args))
    want = getattr(jax_lib, fn)(*args)
    assert got.shape == shape and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_cartpole_matches_numpy_oracle():
    args = cartpole_case()
    got = native.cartpole_rollout(*args)
    want = np_oracle.cartpole_rollout(*args)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_quad3d_matches_numpy_oracle():
    x0, thrusts, dt, n_sub, mass, j = quad3d_case()
    got = native.quad3d_rollout(x0, thrusts, dt, n_sub, mass, j)
    want = np_oracle.quad_rollout(3, x0, thrusts, dt, n_sub, mass, j)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("batch", [1, 8])
def test_float64_engine_matches_oracle(batch):
    """Triangulation: the port's float64 3D env on the CPU (K1's plain
    version, one call a step) against the port's C++ oracle, each env under
    its own thrust sequence, at tests/test_native.py:54's tolerance."""
    env = tq.make_quadrotor(tq.QuadrotorConfig(
        quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=2, task="stabilization",
        cost="quadratic", randomized_init=False, init_state={"init_z": 1.0},
        randomized_inertial_prop=False, done_on_out_of_bound=False, dtype=torch.float64),
        device="cpu")
    steps = 40
    thrusts = HOVER * (1 + 0.03 * np.random.default_rng(1).standard_normal((batch, steps, 4)))
    state, _, _ = env.reset(torch.arange(batch, dtype=torch.int32))
    xs = [state.x.clone()]
    for t in range(steps):
        state, _, _, _, _ = env.step(state, torch.from_numpy(thrusts[:, t]))
        xs.append(state.x.clone())
    got = torch.stack(xs, 1).numpy()
    assert got.dtype == np.float64
    for b in range(batch):
        want = native.quad3d_rollout(got[b, 0], thrusts[b], 1 / 240, 4,
                                     float(state.mass[b]), state.j_diag[b])
        np.testing.assert_allclose(got[b], want, rtol=1e-9, atol=1e-10)


def test_fallback_matches_the_library():
    assert native.available()
    args = cartpole_case(seed=2, steps=20, n_sub=2)
    np.testing.assert_allclose(_fallback.cartpole_rollout(*args), native.cartpole_rollout(*args),
                               rtol=1e-12, atol=1e-12)
    args = quad3d_case(seed=2, steps=25, n_sub=3, spread=0.05)
    np.testing.assert_allclose(_fallback.quad3d_rollout(*args), native.quad3d_rollout(*args),
                               rtol=1e-10, atol=1e-12)


def test_missing_toolchain_warns_and_falls_back(tmp_path, monkeypatch):
    """With no C++ compiler the entry points still answer, through the NumPy
    fallback, after one RuntimeWarning; the logger degrades to the Python
    ring."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "LIB", tmp_path / "build" / "libscg_native.so")
    monkeypatch.setattr(native, "_compiler", lambda: ["scg-no-such-compiler"])
    args = cartpole_case(seed=2, steps=20, n_sub=2)
    with pytest.warns(RuntimeWarning, match="NumPy fallback"):
        out = native.cartpole_rollout(*args)
    assert not native.available() and native._lib_failed
    np.testing.assert_array_equal(out, _fallback.cartpole_rollout(*args))
    q = native.quad3d_rollout(*quad3d_case(steps=25))
    assert q.shape == (26, 12) and np.isfinite(q).all()
    lg = native.NativeFlightLogger(capacity=4, width=2, header="a,b")
    assert isinstance(lg, _fallback.PyFlightLogger)
    lg.append(torch.arange(12, dtype=torch.float32).reshape(6, 2))
    assert lg.count == 6
    snap = lg.snapshot()
    np.testing.assert_array_equal(snap, np.arange(4, 12, dtype=float).reshape(4, 2))
    path = tmp_path / "fb.csv"
    lg.flush_csv(path)
    np.testing.assert_array_equal(np.loadtxt(path, delimiter=",", skiprows=1), snap)
    assert not native.LIB.exists()


@pytest.mark.parametrize("records", [5, 8, 30])
def test_flight_logger_matches_the_jax_packages(jax_lib, tmp_path, records):
    """Below, at and across a wrap of the ring: equal snapshots, the last
    ``capacity`` records bit for bit, and byte-identical CSV files."""
    capacity, width = 8, 3
    data = np.random.default_rng(records).standard_normal((records, width)) * 1e3
    ours = native.NativeFlightLogger(capacity, width, header="t,a,b")
    theirs = jax_lib.NativeFlightLogger(capacity, width, header="t,a,b")
    assert isinstance(ours, native.NativeFlightLogger)
    ours.append(torch.from_numpy(data[:2]))
    ours.append(data[2:])
    theirs.append(data)
    assert ours.count == theirs.count == records
    snap = ours.snapshot()
    np.testing.assert_array_equal(snap, data[-capacity:])
    np.testing.assert_array_equal(snap, theirs.snapshot())
    ours.flush_csv(tmp_path / "ours.csv")
    theirs.flush_csv(str(tmp_path / "theirs.csv"))
    raw = (tmp_path / "ours.csv").read_bytes()
    assert raw == (tmp_path / "theirs.csv").read_bytes()
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "ours.csv", delimiter=",", skiprows=1,
                                             ndmin=2), snap)


RANK = textwrap.dedent(r"""
    import subprocess, sys, time
    from pathlib import Path
    from safe_control_gym_torch import native

    tmp, me = Path(sys.argv[1]), sys.argv[2]
    native.BUILD = tmp / "build"
    native.LIB = native.BUILD / "libscg_native.so"
    compile_ = subprocess.check_call


    def logged(cmd, **kw):
        with open(tmp / "calls.log", "a") as f:
            f.write(f"{me} compile\n")
        time.sleep(0.2)  # widens the window in which an unlocked build races
        return compile_(cmd, **kw)


    native.subprocess.check_call = logged
    (tmp / f"ready.{me}").touch()
    while len(list(tmp.glob("ready.*"))) < 2:  # both processes build at once
        time.sleep(0.01)
    out = native.cartpole_rollout([0.0, 0.0, 0.1, 0.0], [1.0] * 5, 0.02, 1, 1.0, 0.1, 1.0)
    print(native.load()._name, out.shape)
""")


def test_two_processes_build_one_library(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(tmp_path), str(i)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lib = tmp_path / "build" / "libscg_native.so"
    assert all(o.strip().splitlines()[-1] == f"{lib} (6, 4)" for o in outs), outs
    calls = (tmp_path / "calls.log").read_text().splitlines()
    assert len(calls) == 1, calls  # the other found the library once it held the lock
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == ["build.lock", lib.name]
    import ctypes

    assert ctypes.CDLL(str(lib)).scg_logger_create


def test_native_stands_alone():
    """No module of the port's native package imports JAX or the JAX
    package or names a path in it; its source and build lie in the port."""
    pkg = ROOT / "safe_control_gym_torch" / "native"
    for path in sorted(pkg.glob("*.py")):
        text = path.read_text()
        assert "safe_control_gym_tpu" not in text, path
        for node in ast.walk(ast.parse(text)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n == "jax" or n.startswith(("jax.", "safe_control_gym_tpu"))
                           for n in names), (path, names)
    assert native.SRC == pkg / "scg_native.cpp" and native.SRC.exists()
    assert native.LIB.parent == native.BUILD == pkg / "build"
    assert "#include \"" not in native.SRC.read_text()
