"""Sim2real rehearsal scenario pack.

The port's copy of ``safe_control_gym_tpu/competition/scenarios.py``
(NumPy, references equal to the JAX package's bit for bit), the
counterpart of the reference's ``dev-sim2real/`` directory tree
(reference dev-sim2real/{ellipse,line,slalom,zig_zag_climb,zig_zag_fall,
torus,torus_bodyRates,torus_cmdFullState,lissajous,hypotrochoid,
outward_spiral,outward_spiral_varying_z}/edit_this.py): twelve
trajectory-following rehearsal scenarios used to validate tracking behavior
before flying on hardware. The reference ships each as a copy-pasted
controller directory; here each is a declarative :class:`Scenario` (curve
definition + command mode) and one :class:`ScenarioController` drives any of
them through the same staged command sequence the reference uses
(TAKEOFF -> cmdFullState tracking -> hold -> NOTIFYSETPOINTSTOP -> LAND ->
FINISHED; reference ellipse/edit_this.py:212-258).

Curve shapes and constants are taken from the reference scenario files
(cited per scenario below); the generators are vectorized.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from safe_control_gym_torch.competition.competition_utils import Command

__all__ = ["Scenario", "SCENARIOS", "make_scenario", "ScenarioController"]


def _polyfit_refs(waypoints, deg, n_samples, pitch_deg_bump=3):
    """Waypoint curve-fitting shared by the piecewise scenarios.

    Mirrors the reference's np.polyfit construction (ellipse edit_this.py:
    127-142): fit x/y/z with degree ``deg`` and pitch with ``deg+3`` over the
    waypoint index, then sample evenly.
    """
    wp = np.asarray(waypoints, dtype=float)
    t = np.arange(wp.shape[0])
    ts = np.linspace(t[0], t[-1], n_samples)
    refs = [np.polyval(np.polyfit(t, wp[:, k], deg), ts) for k in range(3)]
    pitch = np.polyval(np.polyfit(t, wp[:, 3], deg + pitch_deg_bump), ts)
    return refs[0], refs[1], refs[2], pitch


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One rehearsal scenario: a reference curve plus its command mode."""

    name: str
    #: Trajectory duration knob; sample count follows the reference's rule.
    trajectory_length: float
    #: (ctrl_freq) -> (ref_x, ref_y, ref_z, ref_pitch) arrays.
    generate: Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    #: 'full_state' sends position setpoints; 'body_rates' sends rpy-rate
    #: setpoints (reference torus_bodyRates variant).
    command_mode: str = "full_state"


def _waypoint_scenario(name, waypoints, deg, length):
    def gen(ctrl_freq):
        n = int(length * ctrl_freq)
        return _polyfit_refs(waypoints, deg, n)
    return Scenario(name, length, gen)


def _parametric_scenario(name, fx, fy, fz, length, command_mode="full_state"):
    # The reference curves are parameterized on a 30 Hz step clock (torus
    # edit_this.py:143-145, sampled at exactly 30 Hz).  One sample is emitted
    # per control tick, so at other ctrl_freqs the step argument is rescaled
    # to keep the flown trajectory (shape AND duration) identical.
    def gen(ctrl_freq):
        n = int(length * ctrl_freq)
        steps = np.arange(n, dtype=float) * (30.0 / ctrl_freq)
        zeros = np.zeros_like(steps)
        return (np.asarray(fx(steps), dtype=float) + zeros,
                np.asarray(fy(steps), dtype=float) + zeros,
                np.asarray(fz(steps), dtype=float) + zeros,
                zeros)
    return Scenario(name, length, gen, command_mode)


_LISSAJOUS_LEN = 9.43333333333  # ~3*pi: one lissajous period at the 30 Hz clock


def _torus_xyz(scale=1.0, offset_x=-1.5, base_z=1.0):
    R, r = 1.0, 0.5
    fx = lambda s: (np.cos(s / 30) * (R + r * np.cos(s / 10))) * scale + offset_x
    fy = lambda s: (np.sin(s / 30) * (R + r * np.sin(s / 10))) * scale
    fz = lambda s: base_z + 0.5 * r * np.sin(s / 10) * scale
    return fx, fy, fz


def _build_registry() -> Dict[str, Scenario]:
    reg: Dict[str, Scenario] = {}

    # -- waypoint/polyfit family (heights are scenario knowledge) ----------
    # reference line/edit_this.py:117-126
    f = 1.5
    reg["line"] = _waypoint_scenario(
        "line",
        [(0, 0, 1, 0), (1, 0, 1.25, np.pi / f), (0, 0, 1.25, -np.pi / f), (0, 0, 1, 0)],
        deg=4, length=4.0)
    # reference ellipse/edit_this.py:117-125
    reg["ellipse"] = _waypoint_scenario(
        "ellipse",
        [(0, 0, 1, 0), (0.5, 0, 1.25, np.pi), (1, 0, 1.5, 0), (0, 0, 1.5, 0),
         (-1, 0, 1.5, 0), (-0.5, 0, 1.25, -np.pi), (0, 0, 1, 0)],
        deg=4, length=4.0)
    # reference slalom/edit_this.py:143-151 (y_offset=0)
    reg["slalom"] = _waypoint_scenario(
        "slalom",
        [(0, 0, 1, 0), (1, 1, 1, 0), (-1, 2, 1, 0), (1, 3, 1, 0), (0, 4, 1, 0)],
        deg=5, length=6.0)
    # reference zig_zag_climb/edit_this.py:143-148
    reg["zig_zag_climb"] = _waypoint_scenario(
        "zig_zag_climb",
        [(0, 0, 0.35, 0), (1, 1, 0.7, 0), (-1, -1, 1.225, 0), (0, 0, 1.75, 0)],
        deg=5, length=6.0)
    # reference zig_zag_fall/edit_this.py:143-148 (climb reversed)
    reg["zig_zag_fall"] = _waypoint_scenario(
        "zig_zag_fall",
        [(0, 0, 1.75, 0), (-1, -1, 1.225, 0), (1, 1, 0.7, 0), (0, 0, 0.35, 0)],
        deg=5, length=6.0)

    # -- parametric family ---------------------------------------------------
    # reference torus/edit_this.py:153-170
    fx, fy, fz = _torus_xyz()
    reg["torus"] = _parametric_scenario("torus", fx, fy, fz, _LISSAJOUS_LEN)
    # reference torus_cmdFullState/edit_this.py:878-895 (same curve, explicit
    # full-state command variant)
    reg["torus_cmd_full_state"] = _parametric_scenario(
        "torus_cmd_full_state", fx, fy, fz, _LISSAJOUS_LEN)
    # reference torus_bodyRates/edit_this.py:153-170: the same angular clock
    # scaled into rate commands (x2500) sent as rpy_rates.
    bx, by, bz = _torus_xyz(scale=2500.0, offset_x=0.0, base_z=0.0)
    reg["torus_body_rates"] = _parametric_scenario(
        "torus_body_rates", bx, by,
        lambda s: 0.5 * 2500.0 * np.sin(s / 10),
        _LISSAJOUS_LEN, command_mode="body_rates")
    # reference lissajous/edit_this.py:154-159
    reg["lissajous"] = _parametric_scenario(
        "lissajous",
        lambda s: np.cos(3 * s / 30) - 1,
        lambda s: np.sin(2 * s / 30),
        lambda s: np.ones_like(s),
        _LISSAJOUS_LEN)
    # reference hypotrochoid/edit_this.py:153-169 (R=5, r=3, d=5)
    R, r, d = 5.0, 3.0, 5.0
    reg["hypotrochoid"] = _parametric_scenario(
        "hypotrochoid",
        lambda s: ((R - r) * np.cos(s / 10) + d * np.cos((R - r) * s / 10 / r)) / 7 - 1,
        lambda s: ((R - r) * np.sin(s / 10) - d * np.sin((R - r) * s / 10 / r)) / 7,
        lambda s: 1 + 0.3 * np.sin(s / 30),
        2 * np.pi)
    # reference outward_spiral/edit_this.py:148-153 (factor=1)
    reg["outward_spiral"] = _parametric_scenario(
        "outward_spiral",
        lambda s: (s / 100) * np.cos(s / 20) * 2 / 3,
        lambda s: (s / 100) * np.sin(s / 20) * 2 / 3,
        lambda s: np.ones_like(s),
        _LISSAJOUS_LEN)
    # reference outward_spiral_varying_z/edit_this.py:154-159
    reg["outward_spiral_varying_z"] = _parametric_scenario(
        "outward_spiral_varying_z",
        lambda s: (s / 100) * np.cos(s / 20) * 2 / 3,
        lambda s: (s / 100) * np.sin(s / 20) * 2 / 3,
        lambda s: 1 + 0.7 * np.sin(s / 50),
        _LISSAJOUS_LEN)
    return reg


SCENARIOS: Dict[str, Scenario] = _build_registry()


def make_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario '{name}'; available: {sorted(SCENARIOS)}") from None


class ScenarioController:
    """Drives one rehearsal scenario through the firmware command interface.

    Same staged sequence as every reference dev-sim2real controller
    (ellipse/edit_this.py:212-258): TAKEOFF at iteration 0; from t=3 s track
    the reference samples via cmdFullState (or rpy-rate commands for the
    body-rate scenario); hold the final sample for 2 s; NOTIFYSETPOINTSTOP;
    LAND; FINISHED at trajectory_length + 8 s.
    """

    TAKEOFF_HEIGHT = 1.0
    TAKEOFF_DURATION = 2.0
    HOLD_SEC = 2.0
    LAND_DURATION = 3.0

    def __init__(self, scenario, ctrl_freq: int, feedthrough_pitch_rate: bool = False,
                 velocity_feedforward: bool = False):
        """``feedthrough_pitch_rate`` reproduces the reference scenarios'
        exact command stream (ellipse edit_this.py:225: the fitted *pitch
        angle* profile sent in the rpy_rates field).  Default off: a rate-
        loop-faithful Mellinger treats that profile as a standing rate
        demand and diverges, so the rate feed-forward ships zeroed.

        ``velocity_feedforward`` optionally sends the finite-difference
        velocity of the reference samples with each full-state command; the
        reference (and the default here) sends zeros — the tracking lag is
        part of what the sim2real rehearsal measures."""
        if isinstance(scenario, str):
            scenario = make_scenario(scenario)
        self.scenario = scenario
        self.CTRL_FREQ = int(ctrl_freq)
        self.feedthrough_pitch_rate = feedthrough_pitch_rate
        self.velocity_feedforward = velocity_feedforward
        self.ref_x, self.ref_y, self.ref_z, self.ref_pitch = scenario.generate(ctrl_freq)
        self._len = float(scenario.trajectory_length)

    def reference(self) -> np.ndarray:
        """(N, 3) sampled reference positions (plotting / logging)."""
        return np.stack([self.ref_x, self.ref_y, self.ref_z], axis=-1)

    def cmdFirmware(self, time_s: float, obs=None, reward=None, done=None,
                    info=None) -> Tuple[Command, list]:
        it = int(time_s * self.CTRL_FREQ)
        freq = self.CTRL_FREQ
        track_start = 3 * freq
        track_end = int((self._len + 3) * freq)
        stop_it = int((self._len + 3 + self.HOLD_SEC) * freq) - 1

        if it == 0:
            return Command.TAKEOFF, [self.TAKEOFF_HEIGHT, self.TAKEOFF_DURATION]
        if track_start <= it < track_end:
            step = min(it - track_start, len(self.ref_x) - 1)
            if self.scenario.command_mode == "body_rates":
                rates = np.array([self.ref_x[step], self.ref_y[step], self.ref_z[step]])
                return Command.FULLSTATE, [np.zeros(3), np.zeros(3), np.zeros(3), 0.0, rates]
            pos = np.array([self.ref_x[step], self.ref_y[step], self.ref_z[step]])
            vel = np.zeros(3)
            if self.velocity_feedforward and step + 1 < len(self.ref_x):
                nxt = np.array([self.ref_x[step + 1], self.ref_y[step + 1],
                                self.ref_z[step + 1]])
                vel = (nxt - pos) * self.CTRL_FREQ
            rpy_rates = np.zeros(3)
            if self.feedthrough_pitch_rate:
                rpy_rates = np.array([0.0, self.ref_pitch[step], 0.0])
            return Command.FULLSTATE, [pos, vel, np.zeros(3), 0.0, rpy_rates]
        if track_end <= it < stop_it:
            pos = np.array([self.ref_x[-1], self.ref_y[-1], self.ref_z[-1]])
            return Command.FULLSTATE, [pos, np.zeros(3), np.zeros(3), 0.0, np.zeros(3)]
        if it == stop_it:
            return Command.NOTIFYSETPOINTSTOP, []
        if it == stop_it + 1:
            return Command.LAND, [0.0, self.LAND_DURATION]
        if it >= int((self._len + 8) * freq):
            return Command.FINISHED, []
        return Command.NONE, []
