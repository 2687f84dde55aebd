from soft_robot_control_tpu_torch.rom.pod import (POD, compute_POD,  # noqa: F401
                                                  load_POD, pod_config,
                                                  run_POD)
