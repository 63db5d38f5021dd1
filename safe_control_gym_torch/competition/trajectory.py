"""Polynomial trajectory algebra and piecewise trajectories.

The port's copy of ``safe_control_gym_tpu/competition/trajectory.py``
(NumPy, results equal to the JAX package's bit for bit), the counterpart
of reference competition/trajectory.py: fast
polynomial ops (add/mul/derivative/roots via the companion matrix,
trajectory.py:79-108), parametric curves with closest-point and arclength
queries, and ``Trajectory``/``PiecewiseTrajectory`` with landmarks.

Host-side NumPy (planning happens once per episode); sampled outputs feed
the on-device MPCC path lookup.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


# -- fastpoly (coefficients low->high order) ----------------------------------

def poly_add(a, b):
    n = max(len(a), len(b))
    out = np.zeros(n)
    out[: len(a)] += a
    out[: len(b)] += b
    return out


def poly_mul(a, b):
    return np.convolve(a, b)


def poly_der(a):
    if len(a) <= 1:
        return np.zeros(1)
    return np.asarray(a[1:]) * np.arange(1, len(a))


def poly_eval(a, t):
    t = np.asarray(t)
    return sum(c * t**i for i, c in enumerate(a))


def poly_roots(a):
    """Real roots via the eigenvalues of the companion matrix
    (reference trajectory.py:92-108)."""
    a = np.trim_zeros(np.asarray(a, float), "b")
    if len(a) <= 1:
        return np.array([])
    c = a / a[-1]
    n = len(c) - 1
    M = np.zeros((n, n))
    M[1:, :-1] = np.eye(n - 1)
    M[:, -1] = -c[:-1]
    ev = np.linalg.eigvals(M)
    return np.real(ev[np.abs(ev.imag) < 1e-9])


@dataclasses.dataclass
class Trajectory:
    """One polynomial segment per axis over [start_time, end_time].

    coeffs: list of 3 arrays (low->high) giving position per axis as a
    function of *local* time t - start_time.
    """

    coeffs: Sequence[np.ndarray]
    start_time: float
    end_time: float
    landmarks: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    def add_landmark(self, name: str, t: float):
        self.landmarks.append((name, t))

    def position(self, t):
        tau = np.asarray(t) - self.start_time
        return np.stack([poly_eval(c, tau) for c in self.coeffs], -1)

    def velocity(self, t):
        tau = np.asarray(t) - self.start_time
        return np.stack([poly_eval(poly_der(c), tau) for c in self.coeffs], -1)

    def sample(self, n: int):
        ts = np.linspace(self.start_time, self.end_time, n)
        return ts, self.position(ts), self.velocity(ts)

    def closest_point(self, point, n: int = 200):
        """(time, point, distance) of the closest sampled curve point
        (reference ParametricCurve.closest_point)."""
        ts, ps, _ = self.sample(n)
        d = np.linalg.norm(ps - np.asarray(point), axis=-1)
        i = int(d.argmin())
        return ts[i], ps[i], d[i]

    def arclength(self, n: int = 400) -> float:
        _, ps, _ = self.sample(n)
        return float(np.linalg.norm(np.diff(ps, axis=0), axis=-1).sum())


@dataclasses.dataclass
class PiecewiseTrajectory:
    """Concatenation of segments with global time (reference trajectory.py)."""

    segments: List[Trajectory]

    def __post_init__(self):
        # Re-time segments back-to-back.
        t = self.segments[0].start_time if self.segments else 0.0
        retimed = []
        for seg in self.segments:
            d = seg.duration
            retimed.append(
                Trajectory(seg.coeffs, t, t + d, list(seg.landmarks))
            )
            t += d
        self.segments = retimed

    @property
    def start_time(self) -> float:
        return self.segments[0].start_time

    @property
    def end_time(self) -> float:
        return self.segments[-1].end_time

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    @property
    def landmarks(self):
        out = []
        for seg in self.segments:
            out.extend(seg.landmarks)
        return out

    def _segment_at(self, t: float) -> Trajectory:
        for seg in self.segments:
            if t <= seg.end_time:
                return seg
        return self.segments[-1]

    def _eval(self, t, what: str):
        """Position or velocity (n, 3) at times ``t``: each time on its
        segment (:meth:`_segment_at`, the first whose end is at or after
        it), clipped to the plan; one vectorized call a segment, with the
        same float64 arithmetic, element by element, as a call a time."""
        t = np.atleast_1d(np.asarray(t, float))
        ends = np.asarray([seg.end_time for seg in self.segments])
        idx = np.minimum(np.searchsorted(ends, t, side="left"), len(self.segments) - 1)
        tc = np.clip(t, self.start_time, self.end_time)
        out = np.empty((t.shape[0], 3))
        for k in np.unique(idx):
            m = idx == k
            out[m] = getattr(self.segments[k], what)(tc[m]).reshape(-1, 3)
        return out

    def position(self, t):
        return self._eval(t, "position")

    def velocity(self, t):
        return self._eval(t, "velocity")

    def sample(self, n: int):
        ts = np.linspace(self.start_time, self.end_time, n)
        return ts, self.position(ts).reshape(n, -1), self.velocity(ts).reshape(n, -1)

    def arclength_table(self, n: int = 1000):
        """(theta grid, positions, cumulative arclength) for MPCC lookup."""
        ts, ps, vs = self.sample(n)
        s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(ps, axis=0), axis=-1))])
        return ts, ps, vs, s


@dataclasses.dataclass
class DenseTrajectory:
    """Uniformly-sampled reference with interpolated queries."""

    ts: np.ndarray  # (N,)
    pos: np.ndarray  # (N, 3)
    vel: np.ndarray  # (N, 3)

    @property
    def start_time(self) -> float:
        return float(self.ts[0])

    @property
    def end_time(self) -> float:
        return float(self.ts[-1])

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    def position(self, t):
        t = np.clip(t, self.ts[0], self.ts[-1])
        return np.stack([np.interp(t, self.ts, self.pos[:, i]) for i in range(3)], -1)

    def velocity(self, t):
        t = np.clip(t, self.ts[0], self.ts[-1])
        return np.stack([np.interp(t, self.ts, self.vel[:, i]) for i in range(3)], -1)

    def sample(self, n: int):
        ts = np.linspace(self.ts[0], self.ts[-1], n)
        return ts, self.position(ts), self.velocity(ts)

    def arclength_table(self, n: int = 1000):
        ts, ps, vs = self.sample(n)
        s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(ps, axis=0), axis=-1))])
        return ts, ps, vs, s


def retime_trajectory(
    traj,
    gate_centers=(),
    v_max: float = 1.5,
    v_gate: float = 0.5,
    a_max: float = 2.0,
    gate_radius: float = 0.7,
    n_samples: int = 2000,
    dt_out: float = 0.02,
    v_first: float = None,
) -> DenseTrajectory:
    """TOPP-style retiming of a planned path: cap speed at ``v_max``
    (``v_gate`` within ``gate_radius`` of a gate), enforce the tangential
    acceleration limit with forward/backward passes, and resample uniformly
    in the new time.  Produces a dynamically-consistent position+velocity
    reference that tracking controllers can follow without overshoot — the
    planner's bang-bang timing is typically too aggressive to track
    (reference mpcc/spline stages slow it ad hoc)."""
    _, ps, _ = traj.sample(n_samples)
    ps = ps[:, :3]
    ds = np.linalg.norm(np.diff(ps, axis=0), axis=-1)
    ds = np.maximum(ds, 1e-9)
    v_lim = np.full(n_samples, v_max)
    for g in gate_centers:
        d = np.linalg.norm(ps - np.asarray(g), axis=-1)
        v_lim = np.where(d < gate_radius, np.minimum(v_lim, v_gate), v_lim)
    if v_first is not None and len(gate_centers):
        # Cautious first leg: the takeoff->race handoff happens mid-transient
        # and the stock-gain tracker is underdamped — full race pace before
        # the first gate turns the handoff kick into a persistent swing
        # (short first legs, e.g. level2 seed 5's 1.3 m, are the worst).
        i0 = int(np.linalg.norm(ps - np.asarray(gate_centers[0]), axis=-1).argmin())
        v_lim[:i0] = np.minimum(v_lim[:i0], v_first)
    v = v_lim.copy()
    v[0] = 0.0
    v[-1] = 0.0
    for i in range(1, n_samples):  # forward (accel limit)
        v[i] = min(v[i], np.sqrt(v[i - 1] ** 2 + 2 * a_max * ds[i - 1]))
    for i in range(n_samples - 2, -1, -1):  # backward (decel limit)
        v[i] = min(v[i], np.sqrt(v[i + 1] ** 2 + 2 * a_max * ds[i]))
    v_avg = np.maximum(0.5 * (v[:-1] + v[1:]), 1e-3)
    t = np.concatenate([[0.0], np.cumsum(ds / v_avg)])
    ts_out = np.arange(0.0, t[-1], dt_out)
    pos_out = np.stack([np.interp(ts_out, t, ps[:, i]) for i in range(3)], -1)
    vel_out = np.gradient(pos_out, dt_out, axis=0)
    return DenseTrajectory(ts_out, pos_out, vel_out)
