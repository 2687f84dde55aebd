"""Twins of the repository's tools/ scripts on the port, run as
`python -m soft_robot_control_tpu_torch.tools.<name>`."""
