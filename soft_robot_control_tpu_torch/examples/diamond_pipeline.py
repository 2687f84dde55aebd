"""The Diamond pipeline end to end: collect data, POD, TPWL, the rollout
check, the GuSTO MPC closed loop and its summary (the reference's
examples/diamond/diamond.py recipe sequence on the surrogate plant): the
twin of examples/diamond_pipeline.py on the port.

    python -m soft_robot_control_tpu_torch.examples.diamond_pipeline \
        [--save-dir runs/diamond_demo] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from soft_robot_control_tpu_torch.utils.device import to_numpy


def pipeline(save_dir, device="cuda", stage=None, log=print):
    """The script's recipe sequence on DiamondRobot(n_nodes=10) at dt 0.02,
    artifacts in save_dir: POD data (15 samples, seed 1), the basis (1e-8,
    'v'), the dictionary (threshold 0.4, 15 samples), the rollout check,
    run_scp (Qz = 200, 5 s after a 0.5 s delay) and the summary from
    1.5 s. `stage(name, fn)` runs each of the five stages (pod_data,
    pod_basis, tpwl_data, rollout_check, run_scp; by default fn()).
    Returns the robot, each stage's result, the target and the summary."""
    from soft_robot_control_tpu_torch.robots import DiamondRobot
    from soft_robot_control_tpu_torch.tasks import recipes
    from soft_robot_control_tpu_torch.tasks.analysis import summarize
    from soft_robot_control_tpu_torch.tasks.targets import sine_setpoint

    stage = stage or (lambda name, fn: fn())
    robot = DiamondRobot(n_nodes=10, device=device)
    robot.dt = 0.02
    robot.sequences.dt = 0.02
    d = save_dir
    os.makedirs(d, exist_ok=True)
    out = {"robot": robot}

    log("1/5 collecting POD snapshots ...")
    out["snap"] = stage("pod_data", lambda: recipes.collect_pod_data(
        robot, d, nbr_samples=15, seed=1))
    log(f"    {len(out['snap']['q'])} snapshots")

    log("2/5 computing POD basis ...")
    out["pod"] = stage("pod_basis", lambda: recipes.compute_pod_basis(
        d, pod_tolerance=1e-8, pod_type="v"))
    log(f"    ROM dim {out['pod']['POD_info']['U'].shape[1]}")

    log("3/5 building TPWL dictionary ...")
    out["model"] = stage("tpwl_data", lambda: recipes.collect_tpwl_data(
        robot, d, threshold=0.4, nbr_samples=15))
    log(f"    {out['model'].num_points} linearization points")

    log("4/5 open-loop fidelity check ...")
    out["check"] = stage("rollout_check",
                         lambda: recipes.tpwl_rollout_check(robot, d))
    log(f"    rollout MSE vs plant: {out['check']['mse']:.3e}")

    log("5/5 closed-loop GuSTO MPC ...")
    Hf = robot.get_output_model()
    z0 = float((to_numpy(robot.plant.x_rest()) @ Hf.T)[0])
    t_t, z_t = sine_setpoint(T=4.0, duration=12.0, dt=0.02, amplitude=0.05)
    z_t = z_t + z0
    out["target"] = (t_t, z_t)
    out["sim"] = stage("run_scp", lambda: recipes.run_scp(
        robot, d, t_t, z_t, Qz=np.array([[200.0]]), sim_duration=5.0,
        delay=0.5))
    out["summary"] = summarize(out["sim"], t_t + 0.5, z_t, t_start=1.5)
    log(f"    tracking MSE: {out['summary']['tracking']['mse']:.3e}; "
        f"solve times: {out['summary']['solve_times']}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--save-dir", default="runs/diamond_demo")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    pipeline(args.save_dir, args.device)


if __name__ == "__main__":
    main()
