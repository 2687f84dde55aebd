"""The Diamond baselines campaign: Koopman MPC and ROMPC closed loops on the
tet-FEM plant of the Diamond mesh, the twin of
examples/diamond_baselines_campaign.py on the port.

The reference demonstrates both baselines against SOFA only
(examples/hardware/diamond_koopman.py:43-461, a MATLAB-trained lifted model
and linear MPC; examples/diamond/diamond_rompc.py:90-145, a
single-linearization ROM, a Luenberger observer and linear MPC). Here the
Koopman model is trained natively (EDMD, models/koopman.py:train_edmd) from
tet-plant data, and ROMPC reads the TPWL dictionary in --out, which the
Diamond TPWL campaign (examples/diamond_tet_campaign.py) writes. Both track
a figure-8 about the rest tip and report the tracking RMSE; the results go
to diamond_baselines.json, which must pass the baselines gate
(examples/campaign_gates.py), or the run's artifacts are quarantined and
the script exits 1.

    python -m soft_robot_control_tpu_torch.examples.diamond_baselines_campaign \
        [--out runs/diamond_tet] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np

from soft_robot_control_tpu_torch.utils.device import (
    resolve_device, run_dtype, to_numpy)


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs float64; the card float32")
    ap.add_argument("--out", default=os.path.join("runs", "diamond_tet"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sim-duration", type=float, default=11.0)
    ap.add_argument("--koopman-samples", type=int, default=60)
    ap.add_argument("--skip-koopman", action="store_true")
    ap.add_argument("--skip-rompc", action="store_true")
    ap.add_argument("--qp-backend", default="pallas",
                    choices=["xla", "pallas"],
                    help="the fused LTI QP solver: 'pallas' runs the "
                    "fixed-iteration staged ADMM in the batched ADMM kernel "
                    "(kernel 1), one launch a solve; 'xla' the adaptive "
                    "residual-driven dense solve. The gate judges tracking "
                    "and solve time either way")
    return ap


def main(argv=None, stage=None):
    """The baselines on argv's flags: the summary they write. `stage(name,
    fn)` runs each leg (named as its recipe), fn() by default."""
    args = parser().parse_args(argv)
    stage = stage or (lambda name, fn: fn())
    from soft_robot_control_tpu_torch.examples.campaign_gates import (
        diamond_gates, enforce)
    from soft_robot_control_tpu_torch.robots.robots import DiamondTetRobot
    from soft_robot_control_tpu_torch.tasks import recipes

    dev = resolve_device(args.device)
    dtype = run_dtype(dev)
    dtype_name = str(dtype)[6:]
    if args.quick:
        args.sim_duration = 3.0
        args.koopman_samples = 16

    t0 = time.time()
    robot = DiamondTetRobot(device=dev, dtype=dtype)
    print(f"[{time.time()-t0:6.1f}s] Diamond tet plant: "
          f"{robot.plant.n_nodes} nodes, state dim {robot.plant.state_dim}, "
          f"{robot.plant.input_dim} cables; device {dev}", flush=True)

    d = args.out
    if not os.path.exists(os.path.join(d, "tpwl_model_snapshots.pkl")):
        raise SystemExit("run examples/diamond_tet_campaign.py first "
                         "(needs the TPWL dictionary in --out)")

    Hf = robot.get_output_model()           # the output node's position
    z_eq = Hf @ to_numpy(robot.plant.x_rest())
    tt = np.arange(0, args.sim_duration + 4.0, robot.dt)
    th = 2 * np.pi * tt / 10.0
    # the figure-8 of run_scp at smaller amplitudes (diamond.py:277-281)
    z_target = np.tile(z_eq, (len(tt), 1))
    z_target[:, 0] += -15.0 * np.sin(th)
    z_target[:, 1] += 7.5 * np.sin(2 * th)

    results = {}

    def score(sim):
        """Tracking RMSE against the delay-shifted target from t = 2 s on,
        and the mean solve time."""
        z = np.asarray(sim["z"])
        t = np.asarray(sim["t"])
        zt = np.stack([np.interp(t - 1.0, tt, z_target[:, j])
                       for j in range(3)], axis=1)
        act = t >= 2.0
        rmse = float(np.sqrt(np.mean(np.sum(
            (z[act][:, :2] - zt[act][:, :2]) ** 2, axis=1))))
        st = np.asarray(sim.get("info", {}).get("solve_times", []))
        return {"tracking_rmse_mm": rmse,
                "solve_ms_mean": float(st.mean() * 1e3) if st.size else None}

    def rescore_existing(prefix):
        """A skipped leg keeps its earlier result, scored again from its
        sim pickle in --out, instead of dropping out of the JSON."""
        p = os.path.join(d, f"{prefix}_sim.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                return score(pickle.load(f))
        return None

    backend = "dense" if dtype_name == "float64" else "condensed"
    if args.skip_rompc:
        r = rescore_existing("rompc")
        if r is not None:
            results["rompc"] = r
            print(f"[{time.time()-t0:6.1f}s] ROMPC (scored again from its "
                  f"sim): RMSE {r['tracking_rmse_mm']:.2f} mm", flush=True)
    else:
        sim = stage("run_rompc", lambda: recipes.run_rompc(
            robot, d, tt, z_target, N=20, N_replan=4,
            Qz=np.diag([100.0, 100.0, 0.0]), R=1e-4 * np.eye(4),
            sim_duration=args.sim_duration, delay=1.0, save_prefix="rompc",
            locp_backend=backend, qp_backend=args.qp_backend))
        results["rompc"] = score(sim)
        print(f"[{time.time()-t0:6.1f}s] ROMPC figure-8: RMSE "
              f"{results['rompc']['tracking_rmse_mm']:.2f} mm", flush=True)

    if args.skip_koopman:
        r = rescore_existing("koopman")
        if r is not None:
            results["koopman"] = r
            print(f"[{time.time()-t0:6.1f}s] Koopman (scored again from its "
                  f"sim): RMSE {r['tracking_rmse_mm']:.2f} mm", flush=True)
    else:
        # trained natively (EDMD); absolute tip targets, normalized by the
        # recipe with the training data's scaling
        sim = stage("run_koopman", lambda: recipes.run_koopman(
            robot, d, tt, z_target, delay_embed=1, degree=2, N=10,
            rollout_horizon=4, sim_duration=args.sim_duration, delay=1.0,
            nbr_samples=args.koopman_samples, save_prefix="koopman",
            absolute_targets=True, locp_backend=backend,
            qp_backend=args.qp_backend))
        results["koopman"] = score(sim)
        print(f"[{time.time()-t0:6.1f}s] Koopman MPC figure-8: RMSE "
              f"{results['koopman']['tracking_rmse_mm']:.2f} mm", flush=True)

    results["figure8_amp_mm"] = [15.0, 7.5]
    results["sim_duration_s"] = args.sim_duration
    results["platform"] = dtype_name
    results["qp_backend"] = args.qp_backend
    path = os.path.join(d, "diamond_baselines.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[{time.time()-t0:6.1f}s] saved diamond_baselines.json", flush=True)

    arts = [path] + [os.path.join(d, f"{prefix}_sim.pkl")
                     for prefix, skip in (("rompc", args.skip_rompc),
                                          ("koopman", args.skip_koopman))
                     if not skip]
    enforce(lambda out: diamond_gates(out, k="baselines"), d, arts, results)
    return results


if __name__ == "__main__":
    main()
