"""Networks, distributions, normalizers, schedules, noise processes and the
a-priori dynamics model (port of ``safe_control_gym_tpu/models``)."""

from safe_control_gym_torch.models.dynamics_model import DynamicsModel
from safe_control_gym_torch.models.normalization import (
    MeanStdNormalizer,
    RescaleNormalizer,
    RewardStdNormalizer,
    RunningMeanStd,
    normalize_angle,
)

__all__ = [
    "DynamicsModel",
    "normalize_angle",
    "RunningMeanStd",
    "MeanStdNormalizer",
    "RewardStdNormalizer",
    "RescaleNormalizer",
]
