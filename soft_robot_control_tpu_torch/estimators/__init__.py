from soft_robot_control_tpu_torch.estimators.ekf import EKFState, DiscreteEKFObserver, ekf_update  # noqa: F401
from soft_robot_control_tpu_torch.estimators.full_state import FullStateObserver  # noqa: F401
from soft_robot_control_tpu_torch.estimators.luenberger import DiscreteLuenbergerObserver  # noqa: F401
