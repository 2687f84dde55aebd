from soft_robot_control_tpu_torch.lqr.riccati import solve_riccati, dare, care, dlqr_gain, clqr_gain  # noqa: F401
from soft_robot_control_tpu_torch.lqr.tvlqr import TrajTrackingLQR, tv_lqr_backward  # noqa: F401
