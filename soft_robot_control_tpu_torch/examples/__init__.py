"""Twins of the repository's example scripts, run on the port as
`python -m soft_robot_control_tpu_torch.examples.<name>`: batched_serving,
realtime_mpc (examples/realtime_mpc_tpu.py), noisy_batch_mpc_campaign,
dubins_gusto and diamond_pipeline, whose `main` calls a function with the
script's constants; and the five campaign scripts (diamond_tet_campaign,
diamond_baselines_campaign, diamond_ssm_campaign, trunk_tet_campaign,
trunk_ssm_campaign), whose `main(argv)` returns the summary it writes and
ends with the gates of campaign_gates."""
