"""The port's default competition stack on the CPU: ``getting_started.run``
with the fused 500 Hz firmware block and the MPCC racing stage on level 2,
seed 2, cut to 3 s (chip_smoke.py's phase_competition flies the same 3 s
on the card).  The takeoff and the first second of the race: no collision, no
early done, the drone airborne once the takeoff is over, the tick-rate
clearance minima reported for every gate and obstacle.
"""

import os

import numpy as np
import yaml

from safe_control_gym_torch.competition import getting_started as tg
from safe_control_gym_torch.competition.controller import Controller as TController

LEVELS = os.path.join(os.path.dirname(__file__), "..", "safe_control_gym_tpu", "competition",
                      "levels")


def _level(n, **kw):
    with open(os.path.join(LEVELS, f"level{n}.yaml")) as f:
        level = yaml.safe_load(f)["quadrotor_config"]
    level.update(kw)
    return level


def test_level2_default_stack_takes_off_and_races():
    """The default stack (fused firmware at 500 Hz, MPCC) on level 2, seed 2,
    cut to 3 s: the takeoff and the first second of the race, with no
    collision and no early done (chip_smoke.py's phase_competition, on the card)."""
    log = []

    class Logging(TController):
        def cmdFirmware(self, t, obs, *a, **k):
            log.append(np.array(obs))
            return super().cmdFirmware(t, obs, *a, **k)

    ep = tg.run(_level(2, seed=2, episode_len_sec=3.0), num_episodes=1, controller_cls=Logging,
                device="cpu")[0]
    assert ep["steps"] == 75 and ep["collisions"] == 0, ep
    assert len(ep["min_gate_margin"]) == 4 and min(ep["min_obstacle_margin"]) > 0, ep
    z = np.array([o[4] for o in log])
    assert z[50:].min() > 0.6, z  # airborne once the takeoff is over
