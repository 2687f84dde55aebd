"""The Diamond TPWL campaign on the tet-FEM plant of the Diamond mesh: the
twin of examples/diamond_tet_campaign.py on the port.

The reference's Diamond pipeline (examples/diamond/diamond.py +
examples/hardware/model.py) at the mesh's dimensions (diamond.vtu: 1628
nodes, a 9768-dim state) with the tet-FEM plant (sim/fem_tet.py) in place
of SOFA:

  1. collect_POD_data   : LHS excitation -> snapshots (diamond.py:73-113)
  2. compute_POD_basis  : SVD, tol 5e-5, type 'a'     (diamond.py:116-137)
  3. collect_TPWL_data  : discrete-dictionary TPWL    (diamond.py:140-191)
  4. TPWL_rollout       : held-out fidelity MSE (hardware/diamond.py:20-73)
  5. run_scp            : GuSTO MPC figure-8 tracking (diamond.py:194-316)
     target: z_x = -20 sin(th) - 5.5, z_y = 10 sin(2 th) + 1.5 about the
     post-gravity rest position, Qz=diag(100,100,0), R=1e-5 I,
     U=[0,1500]^4 (diamond.py:277-292).

Artifacts are written in the reference's pickle layouts. It runs on the
card in float32 by default; --device cpu runs float64. The summary
(diamond_tpwl_campaign.json) must pass the Diamond gates
(examples/campaign_gates.py) on --out, or the run's artifacts are
quarantined and the script exits 1.

    python -m soft_robot_control_tpu_torch.examples.diamond_tet_campaign \
        [--out runs/diamond_tet] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from soft_robot_control_tpu_torch.utils.device import (
    resolve_device, run_dtype, to_numpy)

# each stage's summary fields: a partial rerun drops and refreshes only
# the fields of the stages it runs
STAGE_FIELDS = {
    "collect": ["rom_dim", "tpwl_points", "heldout_rel_err",
                "collect_platform"],
    "mpc": ["scp_rmse_mm", "scp_rmse_unshifted_mm", "scp_solve_ms_mean",
            "scp_plan_rejects", "mpc_platform", "mpc_replan_budget_ms"],
}


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs float64; the card float32")
    ap.add_argument("--out", default=os.path.join("runs", "diamond_tet"))
    ap.add_argument("--samples", type=int, default=40,
                    help="LHS samples for POD data")
    ap.add_argument("--tpwl-samples", type=int, default=40)
    ap.add_argument("--t-step", type=float, default=0.25)
    ap.add_argument("--threshold", type=float, default=40.0,
                    help="TPWL distance threshold (reduced weighted units)")
    ap.add_argument("--eval-type", default="distance",
                    choices=["distance", "dynamics"],
                    help="dictionary point-selection criterion; 'dynamics' "
                    "adds points on one-step prediction error "
                    "(tpwl_utils.py:199-260)")
    ap.add_argument("--pod-tol", type=float, default=5e-5)
    ap.add_argument("--rom-dim", type=int, default=30,
                    help="explicit POD dimension; the energy tolerance "
                    "alone over-selects on float32 data whose singular "
                    "tail sits at the noise floor")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip-collect", action="store_true",
                    help="reuse the POD and TPWL artifacts in --out")
    ap.add_argument("--skip-mpc", action="store_true")
    ap.add_argument("--sim-duration", type=float, default=11.0)
    return ap


def load_summary(path):
    """The previous run's summary at path, or {}."""
    if os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            pass
    return {}


def figure8(z_eq, duration):
    """The campaign's figure-8 about z_eq over `duration` s (1000 points;
    diamond.py:277-281): (t, z)."""
    tt = np.linspace(0, duration, 1000)
    th = np.linspace(0, 2 * np.pi * duration / 10.0, 1000)
    z = np.tile(z_eq, (1000, 1))
    z[:, 0] += -20.0 * np.sin(th) - 5.5
    z[:, 1] += 10.0 * np.sin(2 * th) + 1.5
    return tt, z


def delay_rmse(sim, tt, z_target, delay, t_from):
    """RMS of the tip's x-y distance to z_target(t - delay) from t_from on
    (the controller's plan clock starts when the delay window ends,
    tpwl/controllers.py:95-117)."""
    z = np.asarray(sim["z"])
    t = np.asarray(sim["t"])
    zt = np.stack([np.interp(t - delay, tt, z_target[:, j])
                   for j in range(3)], axis=1)
    act = t >= t_from
    return float(np.sqrt(np.mean(np.sum(
        (z[act][:, :2] - zt[act][:, :2]) ** 2, axis=1))))


def main(argv=None, stage=None):
    """The campaign on argv's flags: the summary it writes. `stage(name,
    fn)` runs each recipe stage (named as its recipe), fn() by default."""
    args = parser().parse_args(argv)
    stage = stage or (lambda name, fn: fn())
    from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
    from soft_robot_control_tpu_torch.examples.campaign_gates import (
        diamond_gates, enforce)
    from soft_robot_control_tpu_torch.robots.robots import DiamondTetRobot
    from soft_robot_control_tpu_torch.tasks import recipes

    dev = resolve_device(args.device)
    tdtype = run_dtype(dev)
    dtype = str(tdtype)[6:]
    if args.quick:
        args.samples = 8
        args.tpwl_samples = 8
        args.sim_duration = 3.0

    t0 = time.time()
    robot = DiamondTetRobot(device=dev, dtype=tdtype)
    print(f"[{time.time()-t0:6.1f}s] Diamond tet plant: "
          f"{robot.plant.n_nodes} nodes, state dim {robot.plant.state_dim}, "
          f"{robot.plant.input_dim} cables; device {dev}", flush=True)

    d = args.out
    os.makedirs(d, exist_ok=True)
    summary_path = os.path.join(d, "diamond_tpwl_campaign.json")
    summary = load_summary(summary_path)
    for part, skip in (("collect", args.skip_collect),
                        ("mpc", args.skip_mpc)):
        if not skip:
            for k in STAGE_FIELDS[part]:
                summary.pop(k, None)

    def persist():
        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=1)

    if not args.skip_collect:
        snap = stage("collect_pod_data", lambda: recipes.collect_pod_data(
            robot, d, nbr_samples=args.samples, t_step=args.t_step))
        print(f"[{time.time()-t0:6.1f}s] POD data: {len(snap['q'])} "
              f"snapshots", flush=True)
        res = stage("compute_pod_basis", lambda: recipes.compute_pod_basis(
            d, pod_tolerance=args.pod_tol, pod_type="a",
            rom_dim=args.rom_dim))
        r = res["POD_info"]["U"].shape[1]
        print(f"[{time.time()-t0:6.1f}s] POD basis: r = {r}", flush=True)
        summary["rom_dim"] = int(r)
        model = stage("collect_tpwl_data", lambda: recipes.collect_tpwl_data(
            robot, d, threshold=args.threshold,
            nbr_samples=args.tpwl_samples, t_step=args.t_step,
            dynamics="discrete", eval_type=args.eval_type))
        print(f"[{time.time()-t0:6.1f}s] TPWL dictionary: "
              f"P = {model.num_points} (discrete, dt={robot.dt})", flush=True)
        summary["tpwl_points"] = int(model.num_points)
        chk = stage("tpwl_rollout_check", lambda: recipes.tpwl_rollout_check(
            robot, d, nbr_samples=6, seed=333, t_step=args.t_step))
        print(f"[{time.time()-t0:6.1f}s] held-out rollout: MSE "
              f"{chk['mse']:.4g}, rel err {chk['rel_err']:.4f}", flush=True)
        summary["heldout_rel_err"] = float(chk["rel_err"])
        summary["collect_platform"] = dtype
        persist()

    if args.skip_mpc:
        return summary

    Hf = robot.get_output_model()          # the output node's position (3,)
    z_eq = Hf @ to_numpy(robot.plant.x_rest())
    tt, z_target = figure8(z_eq, args.sim_duration)
    # the dictionary's own dt; one LOCP a query (max_gusto_iters=0), the
    # trust region off, two one-shot rounds with the plan bound
    # (scp/gusto.py:_build_oneshot)
    sim = stage("run_scp", lambda: recipes.run_scp(
        robot, d, tt, z_target, dt_solver=robot.dt, N=10, N_replan=2,
        Qz=np.diag([100.0, 100.0, 0.0]), R=1e-5 * np.eye(4),
        sim_duration=args.sim_duration, delay=1.0,
        U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
        save_prefix="scp_fig8", max_gusto_iters=0, is_tr_active=False,
        locp_backend="condensed", oneshot_iters=2, plan_bound=60.0,
        dtype=tdtype))
    # scored against the delay-shifted target, and the unshifted beside it
    rmse = delay_rmse(sim, tt, z_target, 1.0, 1.0)
    rmse_unshifted = delay_rmse(sim, tt, z_target, 0.0, 1.0)
    n_active = int((np.asarray(sim["t"]) >= 1.0).sum())
    print(f"[{time.time()-t0:6.1f}s] GuSTO MPC figure-8: tracking RMSE "
          f"{rmse:.3f} mm vs the delay-shifted target ({rmse_unshifted:.3f} "
          f"unshifted) over {n_active} steps", flush=True)
    summary["scp_rmse_mm"] = rmse
    summary["scp_rmse_unshifted_mm"] = rmse_unshifted
    summary["mpc_platform"] = dtype
    info = sim.get("info", {})
    if "solve_times" in info and len(info["solve_times"]):
        st = np.asarray(info["solve_times"])
        print(f"         solve times: mean {st.mean()*1e3:.2f} ms, "
              f"max {st.max()*1e3:.2f} ms", flush=True)
        summary["scp_solve_ms_mean"] = float(st.mean() * 1e3)
    summary["scp_plan_rejects"] = int(info.get("plan_rejects", 0))
    # the flown replan cadence (N_replan * dt), declared beside the solve
    # time, which is gated against the 300 ms workstation budget
    summary["mpc_replan_budget_ms"] = 2 * robot.dt * 1e3
    persist()
    print(f"[{time.time()-t0:6.1f}s] saved diamond_tpwl_campaign.json",
          flush=True)

    arts = [summary_path, os.path.join(d, "scp_fig8_sim.pkl")]
    if not args.skip_collect:
        arts += [os.path.join(d, "pod_model.pkl"),
                 os.path.join(d, "tpwl_model_snapshots.pkl")]
    enforce(diamond_gates, d, arts, summary)
    return summary


if __name__ == "__main__":
    main()
