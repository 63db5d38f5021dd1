"""Controllers (port of ``safe_control_gym_tpu/controllers``): the PPO slice."""
