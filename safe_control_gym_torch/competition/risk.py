"""Episode-level risk advice, online state estimation, gate-pose correction.

The port's copy of ``safe_control_gym_tpu/competition/risk.py`` (NumPy,
decisions equal to the JAX package's), the counterparts of the reference
competition stack's meta-strategy
pieces (reference: competition/risk_adviser.py:26-321,
competition/rate_estimator.py:26-87, and the gate-correction bookkeeping in
competition/ek_controller_impl.py:228-291):

* ``RiskAdviser`` — a small episode-count state machine that decides, before
  each episode, whether to fly a CONSERVATIVE plan (nominal gate poses) or a
  RECKLESS one (re-plan against gate poses measured in earlier episodes).
  Decision table (reference risk_adviser.py:40-67): episodes 1-2 always
  conservative (data collection); episode 3 reckless unless the scene is
  randomized between episodes; episode 4 reckless unless the scene is
  randomized *or* the previous episode crashed; anything later conservative.
  Scene randomization is detected by comparing measured gate poses across the
  first two episodes and against the a-priori poses (risk_adviser.py:78-89).

* ``RateEstimator`` — finite-difference velocity + IIR-filtered Euler-rate ->
  body-rate estimation for observation streams that carry pose only (Vicon).
  The reference ships its body-rate output multiplied by zero because the
  estimate destabilized their controller (rate_estimator.py:83); we keep that
  behavior behind ``body_rates_enabled`` (default False) so drop-in behavior
  matches while the working estimator remains available.

* ``GateCorrector`` — per-step processing of the env's gate-progress info
  (``current_target_gate_{id,type,in_range,pos}``) into a corrections dict:
  first out-of-range sighting of a gate records its *nominal* pose, first
  in-range sighting its *exact* pose; the correction is the position delta
  (ek_controller_impl.py:228-291 semantics).
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "RiskProfile",
    "RiskAdviser",
    "RateEstimator",
    "GateCorrector",
    "gate_data_close",
]

#: Two gate maps closer than this (per-gate position L2) count as identical.
GATE_EQ_TOL = 0.005

#: A placeholder location used before any sighting of a gate exists.
FAR_AWAY = 99.0


def gate_data_close(a: Dict, b: Dict, tol: float = GATE_EQ_TOL) -> bool:
    """True if two {gate_id: pose-sequence} maps agree to ``tol``.

    Pose sequences are compared on their first three entries (x, y, z).
    Mismatched id sets — e.g. an episode that crashed before sighting every
    gate — compare unequal (reference risk_adviser.py:100-119).
    """
    if set(a.keys()) != set(b.keys()):
        return False
    if not a:
        return True
    pa = np.array([np.asarray(a[k], dtype=float)[:3] for k in sorted(a)])
    pb = np.array([np.asarray(b[k], dtype=float)[:3] for k in sorted(b)])
    return bool(np.all(np.linalg.norm(pa - pb, axis=-1) <= tol))


class RiskProfile(enum.Enum):
    CONSERVATIVE = 0
    RECKLESS = 1


class RiskAdviser:
    """Pre-episode risk advice from cross-episode gate observations."""

    def __init__(self, forced_conservative_mode: bool = False):
        self.forced_conservative_mode = forced_conservative_mode
        self._episode = 1
        self._completed: list = []
        self._nominal_maps: list = []
        self._exact_maps: list = []

    # -- queries -----------------------------------------------------------
    def episode_advice(self) -> Tuple[RiskProfile, Dict]:
        """(profile, gate-pose hint). Hint is the measured map iff RECKLESS."""
        profile = self._decide()
        if profile is RiskProfile.RECKLESS:
            return profile, self._exact_maps[0]
        return profile, {}

    def _decide(self) -> RiskProfile:
        if self.forced_conservative_mode or self._episode <= 2:
            return RiskProfile.CONSERVATIVE
        if self._episode == 3:
            if self._scene_randomized_between_episodes():
                return RiskProfile.CONSERVATIVE
            return RiskProfile.RECKLESS
        if self._episode == 4:
            if self._scene_randomized_between_episodes() or not self._completed[-1]:
                return RiskProfile.CONSERVATIVE
            return RiskProfile.RECKLESS
        # Past the four-episode competition format: play safe.
        return RiskProfile.CONSERVATIVE

    # -- updates -----------------------------------------------------------
    def episode_results(self, completed: bool, nominal_map: Dict, exact_map: Dict):
        """Record one finished episode's outcome and gate sightings."""
        self._completed.append(bool(completed))
        self._nominal_maps.append(dict(nominal_map))
        self._exact_maps.append(dict(exact_map))
        self._episode += 1

    # -- internals ----------------------------------------------------------
    def _scene_randomized_between_episodes(self) -> bool:
        """Level-3 detection: priori != exact in ep 1 AND exact drifts ep1->ep2."""
        priori_differs = not gate_data_close(self._nominal_maps[0], self._exact_maps[0])
        drifted = not gate_data_close(self._exact_maps[0], self._exact_maps[1])
        return priori_differs and drifted


class RateEstimator:
    """Finite-difference velocity / body-rate estimation from pose-only obs.

    ``estimate(pos, rpy)`` returns (velocity, body_rates). Velocity is the
    one-step backward difference. Body rates come from IIR-smoothed Euler
    angle rates mapped through the Euler-rate -> body-rate kinematic matrix
    (yaw rate zeroed, matching the reference's Vicon heading handling). The
    reference disables the body-rate output entirely (rate_estimator.py:83);
    ``body_rates_enabled=False`` reproduces that.
    """

    IIR_ALPHA = 0.8

    def __init__(self, dt: float, body_rates_enabled: bool = False):
        self.dt = float(dt)
        self.body_rates_enabled = body_rates_enabled
        self.reset()

    def reset(self):
        self._prev_pos: Optional[np.ndarray] = None
        self._prev_rpy: Optional[np.ndarray] = None
        self._euler_rates_filt = np.zeros(3)

    def estimate(self, pos, rpy) -> Tuple[np.ndarray, np.ndarray]:
        pos = np.asarray(pos, dtype=float)
        rpy = np.asarray(rpy, dtype=float)
        if self._prev_pos is None:
            self._prev_pos = pos
        if self._prev_rpy is None:
            self._prev_rpy = rpy

        vel = (pos - self._prev_pos) / self.dt

        # Wrap angle differences to (-pi, pi]: a roll crossing +/-pi must not
        # read as a ~2*pi/dt rate spike.
        dang = np.mod(rpy - self._prev_rpy + np.pi, 2 * np.pi) - np.pi
        euler_rates = dang / self.dt
        euler_rates[2] = 0.0
        a = self.IIR_ALPHA
        self._euler_rates_filt = a * self._euler_rates_filt + (1.0 - a) * euler_rates
        phi, theta, _ = rpy
        # Euler-rate -> body-rate map (ZYX convention).
        to_body = np.array([
            [1.0, 0.0, -np.sin(theta)],
            [0.0, np.cos(phi), np.sin(phi) * np.cos(theta)],
            [0.0, -np.sin(phi), np.cos(phi) * np.cos(theta)],
        ])
        pqr = to_body @ self._euler_rates_filt
        if not self.body_rates_enabled:
            pqr = np.zeros(3)

        self._prev_pos = pos
        self._prev_rpy = rpy
        return vel, pqr


class GateCorrector:
    """Accumulates nominal vs exact gate poses from per-step env info.

    The env reports the current target gate's pose fuzzed while out of
    detection range and exact once in range (reference quadrotor.py:1096 and
    getting_started info plumbing). The first out-of-range report per gate is
    its nominal pose, the first in-range report its exact pose; the
    correction for downstream trackers is exact - nominal.
    """

    def __init__(self, gate_heights: Optional[Dict[int, float]] = None):
        self._heights = gate_heights or {0: 1.0, 1: 0.525}
        self.reset()

    def reset(self):
        self.nominal: Dict[int, tuple] = {}
        self.exact: Dict[int, tuple] = {}
        self._prev_gate_id: Optional[int] = None
        self._next_gate_id: Optional[int] = None

    def _full_pose(self, gate_pos, gate_type) -> tuple:
        x, y = float(gate_pos[0]), float(gate_pos[1])
        yaw = float(gate_pos[5]) if len(gate_pos) > 5 else 0.0
        z = self._heights.get(int(gate_type), 1.0)
        return (x, y, z, 0.0, 0.0, yaw, int(gate_type))

    def update(self, info: Dict) -> Dict:
        """Ingest one step's info dict; return the corrections snapshot."""
        try:
            gate_id = int(info["current_target_gate_id"])
            gate_type = info["current_target_gate_type"]
            in_range = bool(info["current_target_gate_in_range"])
            gate_pos = info["current_target_gate_pos"]
        except (KeyError, TypeError, ValueError):
            return self.snapshot()

        if gate_id >= 0:
            if gate_id != self._next_gate_id:
                self._prev_gate_id = self._next_gate_id
                self._next_gate_id = gate_id
            pose = self._full_pose(np.atleast_1d(np.asarray(gate_pos, dtype=float)), gate_type)
            if gate_id not in self.nominal and not in_range:
                self.nominal[gate_id] = pose
            if gate_id not in self.exact and in_range:
                self.exact[gate_id] = pose
        return self.snapshot()

    def snapshot(self) -> Dict:
        return {
            "prev_gate_location": self._location(self._prev_gate_id),
            "prev_gate_correction": self._correction(self._prev_gate_id),
            "next_gate_location": self._location(self._next_gate_id),
            "next_gate_correction": self._correction(self._next_gate_id),
            "next_gate_location_is_fuzzy": self._next_gate_id not in self.exact,
            # Every measured frame pose so far, as (x, y, yaw, height) per
            # gate id — the MPCC repulsion hinge tracks the TRUE frame
            # material once revealed (and keeps the wider fuzzy standoff
            # against the nominal pose until then).
            "gate_exact_frames": {
                gid: (p[0], p[1], p[5], p[2]) for gid, p in self.exact.items()
            },
        }

    def _location(self, gate_id) -> np.ndarray:
        if gate_id in self.nominal:
            return np.asarray(self.nominal[gate_id][:3], dtype=float)
        if gate_id in self.exact:
            # First sighting was already in range (spawn next to the gate):
            # no nominal pose exists, but the exact one is authoritative —
            # never report FAR_AWAY alongside fuzzy=False.
            return np.asarray(self.exact[gate_id][:3], dtype=float)
        return np.full(3, FAR_AWAY)

    def _correction(self, gate_id) -> np.ndarray:
        if gate_id in self.nominal and gate_id in self.exact:
            return (np.asarray(self.exact[gate_id][:3], dtype=float)
                    - np.asarray(self.nominal[gate_id][:3], dtype=float))
        return np.zeros(3)
