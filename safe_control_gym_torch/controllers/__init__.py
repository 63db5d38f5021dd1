"""Controllers (port of ``safe_control_gym_tpu/controllers``): PPO, SAC, DDPG,
RARL and RAP, SafeExplorerPPO, LQR, PID, iLQR, MPC, LinearMPC, GP-MPC and the
CBF-QP safety filter."""
