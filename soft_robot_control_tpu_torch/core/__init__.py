from soft_robot_control_tpu_torch.core import packing, types, discretize, constraints  # noqa: F401
