from soft_robot_control_tpu_torch.robots.robots import (DiamondRobot,  # noqa: F401
                                                        FingerRobot,
                                                        SurrogateRobot,
                                                        TrunkRobot)
