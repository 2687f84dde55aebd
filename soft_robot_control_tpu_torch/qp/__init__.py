from soft_robot_control_tpu_torch.qp.admm import QPSolution, solve_qp_dense  # noqa: F401
