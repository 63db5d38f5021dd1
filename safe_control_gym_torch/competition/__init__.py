"""IROS-2022 competition layer: the port of ``safe_control_gym_tpu/competition``.

The fork's application layer on top of the benchmark env: gates/obstacles
maze configs, time-optimal planning through gates, the MPCC racing
controller, stage sequencing, and the firmware-in-the-loop main loop
(``getting_started.run``).  The level configs are the JAX package's YAML
files, read in place (``safe_control_gym_tpu/competition/levels/``).
"""

from safe_control_gym_torch.competition.competition_utils import Command
from safe_control_gym_torch.competition.planning import (
    plan_time_optimal_trajectory_through_gates,
)
from safe_control_gym_torch.competition.risk import (
    GateCorrector,
    RateEstimator,
    RiskAdviser,
    RiskProfile,
)
from safe_control_gym_torch.competition.scenarios import (
    SCENARIOS,
    ScenarioController,
    make_scenario,
)

__all__ = [
    "Command",
    "plan_time_optimal_trajectory_through_gates",
    "GateCorrector",
    "RateEstimator",
    "RiskAdviser",
    "RiskProfile",
    "SCENARIOS",
    "ScenarioController",
    "make_scenario",
]
