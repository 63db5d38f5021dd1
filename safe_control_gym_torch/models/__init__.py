"""Networks, distributions and normalizers (port of ``safe_control_gym_tpu/models``)."""
