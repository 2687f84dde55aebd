"""The Trunk SSM campaign: native SSM identification and nonlinear MPC on the
tet-FEM plant of the Trunk mesh (trunk.vtk: 709 nodes, a 4254-dim state),
the twin of examples/trunk_ssm_campaign.py on the port.

The reference identifies SSM models by exporting decay CSVs to MATLAB's
SSMLearn (examples/diamond/SSM_sysID.py -> SSM_model.mat); here the whole
campaign runs on the tet-FEM Trunk:

  1. decay campaign        : hold each cable pattern, release, record the
                             tip's [q; v] decays (SSM_sysID.py's role)
  2. native SSM fit        : models/ssm_learn.py, a 6-dim spectral
                             subspace, cubic chart, parametrization and
                             reduced dynamics, input matrices from
                             actuated runs
  3. open-loop validation  : held-out actuated trajectory prediction; the
                             model is saved as trunk_SSM_model.mat only when
                             it contracts and predicts, else .rejected.mat
  4. closed-loop SSM MPC   : scp_ssm, the manifold observer and GuSTO
                             (max_gusto_iters=0: one LOCP a query, the
                             diamond_SSM.py:361 configuration) tracking a
                             tip circle on the tet plant, inputs bounded at
                             the identification's envelope.

It runs on the card in float32 by default; --device cpu runs float64. The
summary (trunk_ssm_mpc.json) must pass the Trunk gates
(examples/campaign_gates.py) on --out, or the run's artifacts are
quarantined and the script exits 1.

    python -m soft_robot_control_tpu_torch.examples.trunk_ssm_campaign \
        [--out runs/trunk_tet] [--quick] [--half-levels] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from soft_robot_control_tpu_torch.examples.diamond_ssm_campaign import (
    contracts, held_out_rel, sysid_data, tip_qv_output)
from soft_robot_control_tpu_torch.utils.device import (
    resolve_device, run_dtype, to_numpy)

TIP = 51  # the reference's tip node (examples/trunk/trunk.py:181)


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs float64; the card float32")
    ap.add_argument("--out", default=os.path.join("runs", "trunk_tet"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--amp", type=float, default=200.0,
                    help="cable hold amplitude for decays (mN)")
    ap.add_argument("--sim-duration", type=float, default=6.0)
    ap.add_argument("--skip-mpc", action="store_true")
    ap.add_argument("--fresh-data", action="store_true",
                    help="run the plant again even if sysid_data.pkl exists")
    ap.add_argument("--half-levels", action="store_true",
                    help="add half-amplitude single-cable decay levels")
    return ap


def levels_and_inputs(amp, dt, quick, half_levels):
    """The decay levels (each long cable alone at amp, at amp/2 with
    half_levels, adjacent pairs at amp/1.5; the first 4 with --quick), the
    hold and decay seconds, and the actuated runs' inputs, one a level
    (single long cables, then mixed pairs); the generator continues into
    the held-out inputs."""
    fracs = (1.0, 0.5) if half_levels else (1.0,)
    levels = []
    for frac in fracs:
        for i in range(4):
            lv = np.zeros(8)
            lv[i] = frac * amp
            levels.append(lv)
    levels += [np.array([amp, amp, 0, 0, 0, 0, 0, 0.]) / 1.5,
               np.array([0, amp, amp, 0, 0, 0, 0, 0.]) / 1.5,
               np.array([0, 0, amp, amp, 0, 0, 0, 0.]) / 1.5,
               np.array([amp, 0, 0, amp, 0, 0, 0, 0.]) / 1.5]
    if quick:
        levels = levels[:4]
    hold_t = 1.5 if quick else 2.5
    decay_t = 2.5 if quick else 4.0
    T_act = int(round((hold_t + decay_t) / dt))
    tt = dt * np.arange(T_act)
    rng = np.random.default_rng(0)
    acts = []
    for k in range(len(levels)):
        u = np.zeros((T_act, 8))
        if k < 4:      # a single long cable
            u[:, k] = 0.5 * amp * (1 + np.sin(2 * np.pi * (0.4 + 0.2 * k)
                                              * tt))
        else:          # a mixed pair
            i, j = (k - 4) % 4, (k - 3) % 4
            u[:, i] = 0.4 * amp * (1 + np.sin(2 * np.pi * 0.5 * tt))
            u[:, j] = 0.4 * amp * (1 + np.sin(2 * np.pi * 0.7 * tt
                                              + rng.uniform(0, 2 * np.pi)))
        acts.append(u)
    return levels, hold_t, decay_t, tt, acts, rng


def main(argv=None, stage=None):
    """The campaign on argv's flags: the loop's summary (None with
    --skip-mpc). `stage(name, fn)` runs each stage (sysid_data, learn_ssm,
    held_out_rel, run_closed_loop), fn() by default."""
    args = parser().parse_args(argv)
    stage = stage or (lambda name, fn: fn())
    from soft_robot_control_tpu_torch.control.mpc import scp_ssm
    from soft_robot_control_tpu_torch.control.service import GuSTOService
    from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
    from soft_robot_control_tpu_torch.examples.campaign_gates import (
        enforce, trunk_gates)
    from soft_robot_control_tpu_torch.models import ssm as ssm_mod
    from soft_robot_control_tpu_torch.models.interfaces import SSMGuSTO
    from soft_robot_control_tpu_torch.models.ssm_learn import (learn_ssm,
                                                               save_mat)
    from soft_robot_control_tpu_torch.robots.robots import TrunkTetRobot
    from soft_robot_control_tpu_torch.sim.closed_loop import run_closed_loop
    from soft_robot_control_tpu_torch.tasks.recipes import _host, _Lin
    from soft_robot_control_tpu_torch.utils.io import save_data

    dev = resolve_device(args.device)
    dtype = run_dtype(dev)
    dtype_name = str(dtype)[6:]
    t0 = time.time()

    def log(msg):
        print(f"[{time.time()-t0:6.1f}s] {msg}", flush=True)

    robot = TrunkTetRobot(device=dev, dtype=dtype)
    plant = robot.plant
    log(f"Trunk tet plant: {plant.n_nodes} nodes, state dim "
        f"{plant.state_dim}, {plant.input_dim} cables; device {dev}")
    os.makedirs(args.out, exist_ok=True)
    Hf = tip_qv_output(plant.n_nodes, TIP)
    dt = robot.dt
    art_path = os.path.join(args.out, "trunk_SSM_model.mat")

    def load_accepted():
        return ssm_mod.from_mat(art_path, None, discrete=False,
                                discr_method="be", dtype=dtype, device=dev)

    levels, hold_t, decay_t, tt, acts, rng = levels_and_inputs(
        args.amp, dt, args.quick, args.half_levels)
    decays, acts_data = stage("sysid_data", lambda: sysid_data(
        plant, Hf, levels, acts, hold_t, decay_t, dt,
        os.path.join(args.out, "sysid_data.pkl"), args.fresh_data, log))
    z_eq = Hf @ to_numpy(plant.x_rest())
    # ridge candidates up to 1e4: the decays swing the tip far, and cubic
    # monomials of the reduced coordinates give ill-conditioned normal
    # equations (the held-out data still picks the weight)
    try:
        model = stage("learn_ssm", lambda: learn_ssm(
            [z[5:] for _, z in decays], dt, state_dim=6, SSM_order=3,
            ROM_order=3, n_delay=0, z_ref=z_eq,
            actuated_trajs=[z for z, _ in acts_data],
            input_trajs=[u for _, u in acts_data],
            ridge=[1e-8, 1e-6, 1e-4, 1e-2, 1.0, 1e2, 1e4], joint_fit=True,
            dtype=dtype, device=dev))
    except RuntimeError as e:
        if not os.path.exists(art_path):
            raise
        log(f"fit FAILED ({e}); continuing MPC with the previously "
            "accepted artifact")
        model = load_accepted()
    log(f"SSM trained: state_dim {model.state_dim}")

    # gate 1: an unforced decay from 2 in every observed coordinate
    # contracts (tests/test_trunk_ssm.py::test_trunk_ssm_dims_and_stability)
    n0, nT, stable = contracts(model, 2.0 * np.ones(6), 200, 0.01)
    log(f"stability gate: |x| {n0:.3f} -> {nT:.3f} over 200 unforced steps "
        f"-> {'PASS' if stable else 'FAIL'}")

    # gate 2: held-out actuated runs on the long cables, stepped one by one
    u_tests = []
    for _ in levels:
        u_t = 0.4 * args.amp * (1 + np.sin(
            2 * np.pi * 0.5 * tt[:, None]
            + rng.uniform(0, 2 * np.pi, 8)[None, :]))
        u_t[:, 4:] = 0.0
        u_tests.append(u_t)
    rel, rels = stage("held_out_rel", lambda: held_out_rel(
        model, plant, Hf, u_tests, dt,
        step=lambda x, u: model.update_state(x, u, dt)))
    log(f"held-out actuated tip prediction rel RMS mean {rel:.3f} over "
        f"{len(rels)} runs ({['%.3f' % r for r in rels]})")

    # saved only when both gates pass: an accepted artifact is never
    # replaced by a worse fit
    if stable and rel < 0.6:
        save_mat(model, art_path)
        log("gates PASS -> saved trunk_SSM_model.mat")
    else:
        rej_path = os.path.join(args.out, "trunk_SSM_model.rejected.mat")
        save_mat(model, rej_path)
        log(f"gates FAIL (stable={stable}, held-out rel {rel:.3f}) -> "
            f"artifact NOT persisted; fit written to "
            f"{os.path.basename(rej_path)} for inspection")
        if not os.path.exists(art_path):
            raise SystemExit(1)
        model = load_accepted()
        log("continuing MPC with the previously accepted artifact")

    if args.skip_mpc:
        return None

    nz = model.output_dim
    t_target = np.arange(0, max(args.sim_duration + 4.0, 10.0), dt)
    amp_z = 8.0
    z_target = np.zeros((len(t_target), nz))
    z_target[:, 0] = amp_z * np.cos(2 * np.pi * t_target / 6.0) - amp_z
    z_target[:, 1] = amp_z * np.sin(2 * np.pi * t_target / 6.0)
    Qz = np.zeros((nz, nz))
    Qz[0, 0] = Qz[1, 1] = 100.0
    # the solver and the applied command bounded at the identification's
    # envelope: the model knows the plant at u <= amp only
    u_env = min(1.25 * args.amp, robot.u_max)
    # the service plans and the controller interpolates on one dt_c grid
    dt_c = 2 * dt
    service = GuSTOService(SSMGuSTO(model), N=3, dt=dt_c, Qz=Qz,
                           R=1e-5 * np.eye(model.input_dim),
                           x0=np.zeros(model.state_dim), t=t_target,
                           z=z_target,
                           U=HyperRectangle(u_env * np.ones(8), np.zeros(8)),
                           verbose=0, max_gusto_iters=0, convg_thresh=1e-3,
                           dtype=dtype)
    controller = scp_ssm(model, None, dt_c, N_replan=2, delay=1.0, wait=True,
                         solver_service=service)
    Cf = robot.get_measurement_model(nodes=[TIP])  # [v_tip; q_tip] raw y
    sim = _host(stage("run_closed_loop", lambda: run_closed_loop(
        plant, controller, sim_duration=args.sim_duration, dt=dt,
        measurement_model=_Lin(Cf, plant.device),
        output_model=_Lin(Hf, plant.device),
        u_limits=(np.zeros(8), u_env * np.ones(8)))))
    z = np.asarray(sim["z"])  # [q_tip; v_tip]
    t = np.asarray(sim["t"])
    zs = z[:, :2] - to_numpy(model.z_ref)[:2]
    mask = t > 1.5
    delay = 1.0  # the controller's plan clock runs at t - delay
    zx = np.interp(t[mask] - delay, t_target, z_target[:, 0])
    zy = np.interp(t[mask] - delay, t_target, z_target[:, 1])
    rmse = float(np.sqrt(np.mean(np.hypot(zs[mask, 0] - zx,
                                          zs[mask, 1] - zy) ** 2)))
    log(f"SSM MPC on tet plant: tracking RMSE {rmse:.2f} mm (circle amp "
        f"{amp_z} mm)")
    save_data(os.path.join(args.out, "ssm_mpc_sim.pkl"), sim)
    st = np.asarray(sim.get("info", {}).get("solve_times", []))
    res = {"tracking_rmse_mm": rmse, "circle_amp_mm": float(amp_z),
           "u_envelope_mN": float(u_env), "amp_mN": float(args.amp),
           "control_dt_s": float(dt_c), "delay_s": delay,
           "mpc_replan_budget_ms": 1e3 * 2 * dt_c,
           "solve_ms_mean": float(st.mean() * 1e3) if st.size else None,
           "platform": dtype_name}
    path = os.path.join(args.out, "trunk_ssm_mpc.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    log("saved trunk_ssm_mpc.json")
    enforce(trunk_gates, args.out,
            [path, os.path.join(args.out, "ssm_mpc_sim.pkl")], res)
    return res


if __name__ == "__main__":
    main()
