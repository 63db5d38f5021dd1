"""Controllers (port of ``safe_control_gym_tpu/controllers``): PPO, LQR and PID."""
