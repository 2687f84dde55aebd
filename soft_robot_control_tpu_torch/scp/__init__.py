from soft_robot_control_tpu_torch.scp.locp import LOCP, LOCPSpec  # noqa: F401
from soft_robot_control_tpu_torch.scp.gusto import GuSTO, GuSTOParams  # noqa: F401
