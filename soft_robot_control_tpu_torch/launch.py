"""Experiment launcher: the problem choice and the headless recipe loop on
the port, one argparse CLI with the robots, recipes and printed JSON of the
repository's launch.py:

    python -m soft_robot_control_tpu_torch.launch ROBOT RECIPE \
        [--save-dir runs/default] [--dt 0.02] [--duration 6] [--seed 0] \
        [--device cuda|cpu]

for example `diamond collect_pod_data --save-dir runs/diamond`, then
compute_pod_basis, collect_tpwl_data, tpwl_check, run_scp, run_ilqr,
run_scp_ol, run_rompc, run_koopman, modal_analysis or calibrate_rest on
the same directory.

The plant and the models run on `--device` (the card unless `cpu` is
asked for), in float64: the robots' default, and what launch.py's
`--platform cpu` gives the JAX package. `diamond_tet` and `trunk_tet` need
the reference meshes, which the repository does not hold: their plants
raise FileNotFoundError, as the JAX package's do.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from soft_robot_control_tpu_torch.utils.device import resolve_device, to_numpy


def get_robot(name: str, dt: float, device="cuda"):
    """The robot `name` on `device`; the surrogate robots step at dt, the
    tet-FEM robots at the 0.01 baked into their plant."""
    from soft_robot_control_tpu_torch.robots import (DiamondRobot,
                                                     FingerRobot, TrunkRobot)
    from soft_robot_control_tpu_torch.robots.robots import (DiamondTetRobot,
                                                            TrunkTetRobot)

    cls = {"diamond": DiamondRobot, "trunk": TrunkRobot,
           "finger": FingerRobot,
           "diamond_tet": DiamondTetRobot, "trunk_tet": TrunkTetRobot}[name]
    robot = cls(device=device)
    if not name.endswith("_tet"):
        robot.dt = dt
        robot.sequences.dt = dt
    return robot


def default_target(robot, dt):
    """Gentle sine on the tip output around rest: (t, z) numpy."""
    from soft_robot_control_tpu_torch.tasks.targets import sine_setpoint

    Hf = robot.get_output_model()
    z0 = float((to_numpy(robot.plant.x_rest()) @ Hf.T)[0])
    t, z = sine_setpoint(T=4.0, duration=20.0, dt=dt, amplitude=0.05)
    return t, z + z0


def run(args) -> dict:
    """Run one recipe on the parsed arguments; returns the dict that `main`
    prints."""
    from soft_robot_control_tpu_torch.tasks import recipes
    from soft_robot_control_tpu_torch.tasks.analysis import summarize

    dev = resolve_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    robot = get_robot(args.robot, args.dt, device=dev)
    d = args.save_dir

    if args.recipe == "collect_pod_data":
        snap = recipes.collect_pod_data(robot, d, seed=args.seed)
        return {"snapshots": len(snap["q"])}
    if args.recipe == "compute_pod_basis":
        res = recipes.compute_pod_basis(d, pod_tolerance=1e-8, pod_type="v")
        return {"rom_dim": int(res["POD_info"]["U"].shape[1])}
    if args.recipe == "collect_tpwl_data":
        model = recipes.collect_tpwl_data(robot, d, threshold=0.4,
                                          seed=args.seed)
        return {"tpwl_points": model.num_points}
    if args.recipe == "tpwl_check":
        return {"rollout_mse": recipes.tpwl_rollout_check(robot, d)["mse"]}
    if args.recipe in ("run_scp", "run_ilqr", "run_rompc"):
        t_t, z_t = default_target(robot, args.dt)
        kw = dict(sim_duration=args.duration, delay=0.5)
        if args.recipe == "run_scp":
            sim = recipes.run_scp(robot, d, t_t, z_t, Qz=np.array([[200.0]]),
                                  **kw)
        elif args.recipe == "run_ilqr":
            sim = recipes.run_ilqr(robot, d, t_t, z_t,
                                   Qz=np.array([[200.0]]), tf=args.duration,
                                   **kw)
        else:
            sim = recipes.run_rompc(robot, d, t_t, z_t, **kw)
        stats = summarize(sim, t_t + 0.5, z_t, t_start=1.0,
                          label=args.recipe[4:])
        out = {"tracking_mse": stats["tracking"]["mse"]}
        if args.recipe == "run_scp":
            out["solve_times"] = stats["solve_times"]
        return out
    if args.recipe == "run_scp_ol":
        t_t, z_t = default_target(robot, args.dt)
        res = recipes.run_scp_open_loop(robot, d, t_t, z_t, N=60)
        zopt, topt = to_numpy(res["zopt"]), to_numpy(res["topt"])
        err = float(np.mean((zopt[:, 0] - np.interp(topt, t_t, z_t[:, 0]))
                            ** 2))
        return {"plan_mse": err}
    if args.recipe == "run_koopman":
        t_t = np.arange(0, 20, args.dt)
        z_t = np.full((len(t_t), len(robot.default_output_nodes)), 0.05)
        sim = recipes.run_koopman(robot, d, t_t, z_t,
                                  sim_duration=args.duration, delay=0.5)
        return {"steps": int(len(sim["t"]))}
    if args.recipe == "modal_analysis":
        from soft_robot_control_tpu_torch.sim.modal import (modal_decay_batch,
                                                            mode_shapes)

        w, phi = mode_shapes(robot.plant, n_modes=3)
        w, phi = to_numpy(w), to_numpy(phi)
        res = modal_decay_batch(robot.plant, phi.T, amplitudes=[0.05, 0.1],
                                dt=args.dt, save_dir=os.path.join(d, "modal"))
        return {"modes_hz": list(np.round(w / (2 * np.pi), 3)),
                "cases": sorted(res.keys())}
    # calibrate_rest
    from soft_robot_control_tpu_torch.tasks.calibration import calibrate_rest
    from soft_robot_control_tpu_torch.utils.io import save_data

    q, v = calibrate_rest(robot.plant, dt=args.dt)
    save_data(os.path.join(d, "rest.pkl"), {"rest": [q, v]})
    return {"rest_norm": float(np.linalg.norm(q))}


def parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("robot", choices=["diamond", "trunk", "finger",
                                     "diamond_tet", "trunk_tet"])
    p.add_argument("recipe", choices=[
        "collect_pod_data", "compute_pod_basis", "collect_tpwl_data",
        "tpwl_check", "run_scp", "run_ilqr", "run_scp_ol", "run_rompc",
        "run_koopman", "modal_analysis", "calibrate_rest"])
    p.add_argument("--save-dir", default="runs/default")
    p.add_argument("--dt", type=float, default=0.02)
    p.add_argument("--duration", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the plant and the models run (the card "
                        "unless cpu is asked for)")
    return p


def main(argv=None) -> dict:
    """Parse argv, run the recipe, print its result as one JSON line and
    return it."""
    out = run(parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
