"""Built-in registry entries.

Port of ``safe_control_gym_tpu/_registry_entries.py``: the two envs and the
14 controllers (the reference's 13 of safe_control_gym/controllers/
__init__.py:6-60 plus the firmware's Mellinger controller), with the port's
entry points and the same default configs.  An env builds on CUDA unless
its kwargs carry ``device="cpu"``; a controller runs on its env's device.
"""

from safe_control_gym_torch.utils.registration import register

register(id="quadrotor",
         entry_point="safe_control_gym_torch.envs.quadrotor:make_quadrotor_from_dict")
register(id="cartpole",
         entry_point="safe_control_gym_torch.envs.cartpole:make_cartpole_from_dict")

# (entry_point, default config): the defaults of the reference's per-algo
# YAMLs (controllers/*/{algo}.yaml); None where the constructor's defaults
# are the config surface.
_CONTROLLERS = {
    "pid": ("safe_control_gym_torch.controllers.pid:PID", None),
    "lqr": ("safe_control_gym_torch.controllers.lqr:LQR",
            {"q_lqr": [1.0], "r_lqr": [1.0], "discrete_dynamics": True}),
    "ilqr": ("safe_control_gym_torch.controllers.ilqr:iLQR",
             {"q_lqr": [1.0], "r_lqr": [1.0], "max_iterations": 15,
              "lamb_factor": 10.0, "lamb_max": 1000.0, "epsilon": 0.01}),
    "mpc": ("safe_control_gym_torch.controllers.mpc:MPC",
            {"horizon": 5, "q_mpc": [1.0], "r_mpc": [1.0], "warmstart": True,
             "soft_constraints": False, "constraint_tol": 1e-6}),
    "linear_mpc": ("safe_control_gym_torch.controllers.linear_mpc:LinearMPC",
                   {"horizon": 5, "q_mpc": [1.0], "r_mpc": [1.0]}),
    "gp_mpc": ("safe_control_gym_torch.controllers.gp_mpc:GPMPC",
               {"horizon": 5, "q_mpc": [1.0], "r_mpc": [1.0], "prob": 0.955,
                "num_samples": 300, "num_inducing": 64}),
    "cbf": ("safe_control_gym_torch.controllers.cbf:CBF_QP",
            {"slope": 0.1, "soft_constrained": True, "slack_weight": 10000.0}),
    "ppo": ("safe_control_gym_torch.controllers.ppo:PPO",
            {"hidden_dim": 64, "gamma": 0.99, "use_gae": False,
             "gae_lambda": 0.95, "clip_param": 0.2, "target_kl": 0.01,
             "entropy_coef": 0.01, "opt_epochs": 10, "mini_batch_size": 64,
             "actor_lr": 3e-4, "critic_lr": 1e-3, "max_env_steps": 1_000_000,
             "rollout_batch_size": 4, "rollout_steps": 100}),
    "sac": ("safe_control_gym_torch.controllers.sac:SAC",
            {"hidden_dim": 256, "gamma": 0.99, "tau": 0.005,
             "init_temperature": 0.2, "use_entropy_tuning": False,
             "train_interval": 100, "train_batch_size": 64,
             "actor_lr": 1e-3, "critic_lr": 1e-3, "warm_up_steps": 1000,
             "rollout_batch_size": 4, "max_buffer_size": 1_000_000}),
    "ddpg": ("safe_control_gym_torch.controllers.ddpg:DDPG",
             {"hidden_dim": 256, "gamma": 0.99, "tau": 0.005,
              "train_interval": 100, "train_batch_size": 64,
              "actor_lr": 1e-3, "critic_lr": 1e-3, "warm_up_steps": 10_000,
              "rollout_batch_size": 4, "max_buffer_size": 1_000_000}),
    "safe_explorer_ppo": (
        "safe_control_gym_torch.controllers.safe_explorer:SafeExplorerPPO",
        {"constraint_margin": 0.0, "pretrain_steps": 200}),
    "rarl": ("safe_control_gym_torch.controllers.rarl:RARL",
             {"rollout_batch_size": 4, "rollout_steps": 100,
              "num_pro_iters": 1, "num_adv_iters": 1}),
    "rap": ("safe_control_gym_torch.controllers.rarl:RAP",
            {"num_adversaries": 3, "rollout_batch_size": 4, "rollout_steps": 100}),
    "mellinger": ("safe_control_gym_torch.controllers.mellinger:MellingerController", None),
}
for _id, (_ep, _cfg) in _CONTROLLERS.items():
    register(id=_id, entry_point=_ep, config_entry_point=_cfg)
