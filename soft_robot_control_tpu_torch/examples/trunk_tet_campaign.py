"""The Trunk TPWL campaign on the tet-FEM plant of the Trunk mesh: the twin
of examples/trunk_tet_campaign.py on the port.

The reference's Trunk pipeline (examples/trunk/trunk.py:154-325) at the
mesh's dimensions (trunk.vtk: 709 nodes, a 4254-dim state, 8 cables) with
the tet-FEM plant in place of SOFA:

  1. collect_POD_data   : LHS excitation -> snapshots    (trunk.py:76-127)
  2. compute_POD_basis  : SVD                            (trunk.py:130-151)
  3. collect_TPWL_data  : discrete-dictionary TPWL       (trunk.py:154-211)
  4. TPWL_rollout       : held-out fidelity checks (LHS and a figure-8)
  5. run_scp            : GuSTO MPC figure-8 tracking (trunk.py:213-325):
     z_x = -10 sin th, z_y = 10 sin 2th about the post-gravity rest tip,
     Qz=diag(100,100,0), the trust region on the device (device_tr), a
     40 mm plan bound, LQR feedback at --mpc-feedback-R, u_sat at the
     input bound; optionally a second leg with an input slew bound
     (--dU-leg)
  6. run_ilqr           : iLQR tracking of the same target (trunk.py:327-380)

It runs on the card in float32 by default; --device cpu runs float64. The
summary (trunk_tpwl_campaign.json) must pass the Trunk gates
(examples/campaign_gates.py) on --out, or the run's artifacts are
quarantined and the script exits 1.

    python -m soft_robot_control_tpu_torch.examples.trunk_tet_campaign \
        [--out runs/trunk_tet] [--quick] [--dU-leg 25] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np

from soft_robot_control_tpu_torch.examples.diamond_tet_campaign import (
    delay_rmse, load_summary)
from soft_robot_control_tpu_torch.utils.device import (
    resolve_device, run_dtype, to_numpy)

STAGE_FIELDS = {
    "collect": ["rom_dim", "tpwl_points", "heldout_rel_err",
                "heldout_traj_rel_err", "collect_platform"],
    "mpc": ["scp_rmse_mm", "scp_solve_ms_mean", "scp_plan_rejects",
            "mpc_platform", "mpc_R", "mpc_dU", "mpc_feedback_R",
            "mpc_replan_budget_ms", "scp_reject_reasons",
            "scp_tip_span_mm"],
    "ilqr": ["ilqr_rmse_mm", "ilqr_platform", "ilqr_feedback_R"],
}


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs float64; the card float32")
    ap.add_argument("--out", default=os.path.join("runs", "trunk_tet"))
    ap.add_argument("--samples", type=int, default=40,
                    help="LHS samples for POD data")
    ap.add_argument("--tpwl-samples", type=int, default=40)
    ap.add_argument("--t-step", type=float, default=0.25)
    ap.add_argument("--threshold", type=float, default=15.0)
    ap.add_argument("--rom-dim", type=int, default=30)
    ap.add_argument("--amplitude-scale", type=str, default="0.25",
                    help="LHS excitation amplitude as a fraction of u_max, "
                    "or a comma-separated list of scales (one LHS sequence "
                    "a scale); the reference collects at 200 of 800 mN "
                    "(trunk.py:186)")
    ap.add_argument("--traj", type=str,
                    default="50:1,100:1.5,150:2,200:2.5,250:3,150:10",
                    help="figure-8 excitation segments as amp:period pairs "
                    "appended to the LHS data (trunk.py:104-112, 186-192); "
                    "'' disables")
    ap.add_argument("--solver-N", type=int, default=50,
                    help="MPC horizon steps at the dictionary dt (50 x 0.01 s "
                    "is the reference's 0.5 s horizon)")
    ap.add_argument("--u-bound", type=float, default=250.0,
                    help="MPC input upper bound (mN): the dictionary's "
                    "training envelope")
    ap.add_argument("--mpc-R", type=float, default=1e-2,
                    help="MPC input cost weight")
    ap.add_argument("--mpc-dU", type=float, default=0.0,
                    help="per-step input rate bound |u_k+1 - u_k| (mN); 0 "
                    "disables, as the reference's Trunk example")
    ap.add_argument("--dU-leg", type=float, default=0.0,
                    help="run an extra MPC leg with this input slew bound "
                    "(mN) under scp_fig8_dU_* and record it in the JSON's "
                    "dU_leg block")
    ap.add_argument("--mpc-feedback-R", type=float, default=1.0,
                    help="LQR feedback about the GuSTO plan with DARE gains "
                    "at this R (a moderate gain); 0 disables feedback")
    ap.add_argument("--ilqr-feedback-R", type=float, default=None,
                    help="the iLQR execution gains recomputed along the plan "
                    "at this R (inf = pure feedforward; default keeps the "
                    "iLQR gains)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip-collect", action="store_true",
                    help="reuse the POD and TPWL artifacts in --out")
    ap.add_argument("--skip-pod", action="store_true",
                    help="reuse the POD basis in --out but rebuild the TPWL "
                    "dictionary and the fidelity checks")
    ap.add_argument("--skip-mpc", action="store_true")
    ap.add_argument("--skip-ilqr", action="store_true")
    ap.add_argument("--sim-duration", type=float, default=11.0)
    return ap


def figure8(z_eq, duration):
    """The Trunk's figure-8 ('infinity sign', trunk.py:299-303) about z_eq
    over duration + 4 s (1000 points): (t, z)."""
    tt = np.linspace(0, duration + 4.0, 1000)
    th = 2 * np.pi * tt / 10.0
    z = np.tile(z_eq, (1000, 1))
    z[:, 0] += -10.0 * np.sin(th)
    z[:, 1] += 10.0 * np.sin(2 * th)
    return tt, z


def main(argv=None, stage=None):
    """The campaign on argv's flags: the summary it writes. `stage(name,
    fn)` runs each recipe stage (named as its recipe), fn() by default."""
    args = parser().parse_args(argv)
    stage = stage or (lambda name, fn: fn())
    from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
    from soft_robot_control_tpu_torch.examples.campaign_gates import (
        enforce, trunk_gates)
    from soft_robot_control_tpu_torch.robots.robots import TrunkTetRobot
    from soft_robot_control_tpu_torch.tasks import recipes

    dev = resolve_device(args.device)
    tdtype = run_dtype(dev)
    dtype = str(tdtype)[6:]
    if args.quick:
        args.samples = 6
        args.tpwl_samples = 6
        args.sim_duration = 3.0
    amp = [float(v) for v in str(args.amplitude_scale).split(",")]
    args.amplitude_scale = amp if len(amp) > 1 else amp[0]
    traj = tuple(tuple(float(x) for x in seg.split(":"))
                 for seg in args.traj.split(",") if seg)

    t0 = time.time()

    def log(msg):
        print(f"[{time.time()-t0:6.1f}s] {msg}", flush=True)

    robot = TrunkTetRobot(device=dev, dtype=tdtype)
    log(f"Trunk tet plant: {robot.plant.n_nodes} nodes, state dim "
        f"{robot.plant.state_dim}, {robot.plant.input_dim} cables; "
        f"device {dev}")

    d = args.out
    os.makedirs(d, exist_ok=True)
    summary_path = os.path.join(d, "trunk_tpwl_campaign.json")
    summary = load_summary(summary_path)
    # each stage owns its fields: dropped up front when the stage runs, so
    # that a partial rerun leaves no stale number beside fresh ones
    summary.pop("platform", None)
    for part, skip in (("collect", args.skip_collect),
                        ("mpc", args.skip_mpc), ("ilqr", args.skip_ilqr)):
        if not skip:
            for k in STAGE_FIELDS[part]:
                summary.pop(k, None)
    if args.dU_leg > 0:
        summary.pop("dU_leg", None)

    if not args.skip_collect:
        if not args.skip_pod:
            snap = stage("collect_pod_data", lambda: recipes.collect_pod_data(
                robot, d, nbr_samples=args.samples, t_step=args.t_step,
                amplitude_scale=args.amplitude_scale, traj=traj))
            log(f"POD data: {len(snap['q'])} snapshots")
            res = stage("compute_pod_basis",
                        lambda: recipes.compute_pod_basis(
                            d, pod_tolerance=5e-5, pod_type="a",
                            rom_dim=args.rom_dim))
            r = res["POD_info"]["U"].shape[1]
        else:
            from soft_robot_control_tpu_torch.rom.pod import load_POD
            r = load_POD(os.path.join(d, "pod_model.pkl"), device=dev).rom_dim
        log(f"POD basis: r = {r}")
        summary["rom_dim"] = int(r)
        model = stage("collect_tpwl_data", lambda: recipes.collect_tpwl_data(
            robot, d, threshold=args.threshold,
            nbr_samples=args.tpwl_samples, t_step=args.t_step,
            dynamics="discrete", amplitude_scale=args.amplitude_scale,
            traj=traj))
        log(f"TPWL dictionary: P = {model.num_points}")
        summary["tpwl_points"] = int(model.num_points)
        chk = stage("tpwl_rollout_check", lambda: recipes.tpwl_rollout_check(
            robot, d, nbr_samples=6, seed=333, t_step=args.t_step,
            amplitude_scale=args.amplitude_scale))
        log(f"held-out rollout: MSE {chk['mse']:.4g}, rel err "
            f"{chk['rel_err']:.4f}")
        summary["heldout_rel_err"] = float(chk["rel_err"])
        # the task's regime: a figure-8 at an amplitude and period between
        # the training segments
        chk2 = stage("tpwl_rollout_check", lambda: recipes.tpwl_rollout_check(
            robot, d, traj=(175.0, 2.25)))
        log(f"held-out fig-8 rollout: MSE {chk2['mse']:.4g}, rel err "
            f"{chk2['rel_err']:.4f}")
        summary["heldout_traj_rel_err"] = float(chk2["rel_err"])
        summary["collect_platform"] = dtype

    if args.skip_collect:
        # the dictionary may have been pruned since it was collected
        # (tools/prune_tpwl_dict.py): the summary describes the one flown
        with open(os.path.join(d, "tpwl_model_snapshots.pkl"), "rb") as f:
            dinfo = pickle.load(f).get("info", {})
        if "nbr_lin" in dinfo:
            summary["tpwl_points"] = int(dinfo["nbr_lin"])
        if "pruned_from" in dinfo:
            summary["tpwl_pruned_from"] = int(dinfo["pruned_from"])

    Hf = robot.get_output_model()          # the tip node's position (3,)
    z_eq = Hf @ to_numpy(robot.plant.x_rest())
    tt, z_target = figure8(z_eq, args.sim_duration)
    Qz = np.diag([100.0, 100.0, 0.0])
    R = args.mpc_R * np.eye(8)
    U = HyperRectangle(args.u_bound * np.ones(8), np.zeros(8))
    fbR = args.mpc_feedback_R

    def scp_leg(dU, prefix):
        # the trust-region SCP loop on the device, one dispatch a query,
        # the 40 mm plan bound as a reject, LQR feedback at fbR, the
        # applied command saturated at the input bound
        return stage("run_scp", lambda: recipes.run_scp(
            robot, d, tt, z_target, dt_solver=robot.dt, N=args.solver_N,
            N_replan=2, Qz=Qz, R=R, sim_duration=args.sim_duration,
            delay=1.0, U=U, dU=dU, save_prefix=prefix,
            locp_backend="condensed", dtype=tdtype, device_tr=True,
            plan_bound=40.0, u_sat=args.u_bound, feedback=fbR > 0,
            feedback_R=fbR if fbR > 0 else None))

    def slew(bound):
        return None if bound <= 0 else HyperRectangle(
            bound * np.ones(8), -bound * np.ones(8))

    if not args.skip_mpc:
        sim = scp_leg(slew(args.mpc_dU), "scp_fig8")
        z = np.asarray(sim["z"])
        act = np.asarray(sim["t"]) >= 1.0
        rmse = delay_rmse(sim, tt, z_target, 1.0, 1.0)
        log(f"GuSTO MPC figure-8: tracking RMSE {rmse:.3f} mm (vs "
            f"delay-shifted target)")
        info = sim.get("info", {})
        summary["scp_rmse_mm"] = rmse
        summary["mpc_platform"] = dtype
        summary["scp_plan_rejects"] = int(info.get("plan_rejects", 0))
        rej = info.get("reject_log", [])
        summary["scp_reject_reasons"] = {
            r: sum(1 for e in rej if e.get("reason") == r)
            for r in {e.get("reason") for e in rej}}
        summary["mpc_R"] = args.mpc_R
        summary["mpc_dU"] = args.mpc_dU
        summary["mpc_feedback_R"] = args.mpc_feedback_R
        summary["mpc_replan_budget_ms"] = 2 * robot.dt * 1e3
        # the tip's excursion over the active window, all axes
        summary["scp_tip_span_mm"] = [float(np.ptp(z[act][:, j]))
                                      for j in range(3)]
        st = np.asarray(info.get("solve_times", []))
        if st.size:
            summary["scp_solve_ms_mean"] = float(st.mean() * 1e3)

    if args.dU_leg > 0:
        # the same loop with the slew polytope |u_k+1 - u_k| <= dU active
        sim2 = scp_leg(slew(args.dU_leg), "scp_fig8_dU")
        rmse2 = delay_rmse(sim2, tt, z_target, 1.0, 1.0)
        u2 = np.asarray(sim2["u"])
        st2 = np.asarray(sim2.get("info", {}).get("solve_times", []))
        summary["dU_leg"] = {
            "dU_mN": float(args.dU_leg),
            "scp_rmse_mm": rmse2,
            "plan_rejects": int(sim2.get("info", {}).get("plan_rejects", 0)),
            "applied_du_max_mN": float(np.abs(np.diff(u2, axis=0)).max()),
            "solve_ms_mean": (float(st2.mean() * 1e3) if st2.size else None),
        }
        log(f"GuSTO MPC dU-leg (dU={args.dU_leg} mN): RMSE {rmse2:.3f} mm, "
            f"rejects {summary['dU_leg']['plan_rejects']}")

    if not args.skip_ilqr:
        # iLQR on the TPWL ROM (trunk.py:327-380), R = 1e-2, the applied
        # command saturated at the dictionary's training envelope
        sim = stage("run_ilqr", lambda: recipes.run_ilqr(
            robot, d, tt, z_target, Qz=Qz, R=1e-2 * np.eye(8),
            sim_duration=args.sim_duration, delay=1.0,
            tf=args.sim_duration, save_prefix="ilqr_fig8",
            u_sat=args.u_bound, feedback_R=args.ilqr_feedback_R))
        rmse = delay_rmse(sim, tt, z_target, 1.0, 1.0)
        log(f"iLQR figure-8: tracking RMSE {rmse:.3f} mm (vs delay-shifted "
            f"target)")
        summary["ilqr_rmse_mm"] = rmse
        summary["ilqr_platform"] = dtype
        if args.ilqr_feedback_R is not None:
            summary["ilqr_feedback_R"] = args.ilqr_feedback_R

    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1)
    log("saved trunk_tpwl_campaign.json")

    arts = [summary_path]
    if not args.skip_mpc:
        arts.append(os.path.join(d, "scp_fig8_sim.pkl"))
    if args.dU_leg > 0:
        arts.append(os.path.join(d, "scp_fig8_dU_sim.pkl"))
    if not args.skip_ilqr:
        arts.append(os.path.join(d, "ilqr_fig8_sim.pkl"))
    if not args.skip_collect:
        arts += [os.path.join(d, "pod_model.pkl"),
                 os.path.join(d, "tpwl_model_snapshots.pkl")]
    enforce(trunk_gates, d, arts, summary)
    return summary


if __name__ == "__main__":
    main()
