"""Twins of the repository's example scripts that need no reference mesh,
run on the port as `python -m soft_robot_control_tpu_torch.examples.<name>`:
batched_serving, realtime_mpc (examples/realtime_mpc_tpu.py),
noisy_batch_mpc_campaign, dubins_gusto and diamond_pipeline. Each script's
body is a function that its `main` calls with the script's constants."""
