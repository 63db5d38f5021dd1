"""Networks, distributions, normalizers and the a-priori dynamics model
(port of ``safe_control_gym_tpu/models``)."""
