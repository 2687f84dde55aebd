"""The Diamond SSM campaign: native SSM identification and nonlinear MPC on
the tet-FEM plant of the Diamond mesh, the twin of
examples/diamond_ssm_campaign.py on the port (the reference's
examples/hardware/diamond_SSM.py:144-225 and run_gusto_solver :228-361,
with MATLAB's SSMLearn replaced by models/ssm_learn.py).

  1. decay campaign        : hold each cable pattern, release, record the
                             tip's [q; v] decays (SSM_sysID.py's role)
  2. native SSM fit        : 6-dim spectral subspace, cubic chart,
                             parametrization and reduced dynamics, input
                             matrices from actuated runs (joint [R|B] fit)
  3. acceptance gates      : unforced-decay contraction and held-out
                             actuated fidelity (diamond_SSM.py:21-140): the
                             model is saved as diamond_SSM_model.mat only
                             when both pass, else as .rejected.mat
  4. closed-loop SSM MPC   : scp_ssm, the manifold observer and GuSTO with
                             max_gusto_iters=0 (one LOCP a query,
                             diamond_SSM.py:361), N=3, control dt 0.02,
                             N_replan=2, the figure-8 z = (-15 sin th,
                             15 sin 2th) about the rest tip
                             (diamond_SSM.py:281-282) on the tet plant.

The condensed LOCP runs in kernel 1 (the batched ADMM kernel) on the card,
in float32; --device cpu runs float64.

    python -m soft_robot_control_tpu_torch.examples.diamond_ssm_campaign \
        [--out runs/diamond_tet] [--quick] [--mpc-only] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from soft_robot_control_tpu_torch.utils.device import (
    resolve_device, run_dtype, to_numpy)

TIP = 1354  # the reference's TIP_NODE (examples/hardware/diamond_SSM.py:19)


def tip_qv_output(num_nodes: int, node: int):
    """C giving z = [q_tip; v_tip] from x = [v; q] (the ordering
    models/ssm.py expects; measurement_models.py evaluate(qv=True))."""
    C = np.zeros((6, 6 * num_nodes))
    for k in range(3):
        C[k, 3 * num_nodes + 3 * node + k] = 1.0      # q block of x
        C[3 + k, 3 * node + k] = 1.0                  # v block of x
    return C


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs float64; the card float32")
    ap.add_argument("--out", default=os.path.join("runs", "diamond_tet"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--amp", type=float, default=900.0,
                    help="cable hold amplitude for decays (mN)")
    ap.add_argument("--sim-duration", type=float, default=11.0)
    ap.add_argument("--skip-mpc", action="store_true")
    ap.add_argument("--fresh-data", action="store_true")
    ap.add_argument("--state-dim", type=int, default=6)
    ap.add_argument("--ssm-order", type=int, default=3)
    ap.add_argument("--rom-order", type=int, default=3)
    ap.add_argument("--mpc-only", action="store_true",
                    help="skip fit and gates; run the closed loop with the "
                    "previously accepted diamond_SSM_model.mat")
    return ap


def levels_and_inputs(amp, dt, quick):
    """The decay levels (each cable alone at amp and amp/2, adjacent pairs
    at amp/1.6; the first 4 with --quick), the hold and decay seconds, and
    the actuated runs' inputs, one a level (single-cable sines, then mixed
    pairs); the generator continues into the held-out inputs."""
    levels = []
    for frac in (1.0, 0.5):
        for i in range(4):
            lv = np.zeros(4)
            lv[i] = frac * amp
            levels.append(lv)
    levels += [np.array([amp, amp, 0.0, 0.0]) / 1.6,
               np.array([0.0, amp, amp, 0.0]) / 1.6,
               np.array([0.0, 0.0, amp, amp]) / 1.6,
               np.array([amp, 0.0, 0.0, amp]) / 1.6]
    if quick:
        levels = levels[:4]
    hold_t = 1.5 if quick else 2.0
    decay_t = 2.5 if quick else 4.0
    T_act = int(round((hold_t + decay_t) / dt))
    tt = dt * np.arange(T_act)
    # per-cable sines first: correlated all-cable excitation cannot
    # separate the cables' input directions
    rng = np.random.default_rng(0)
    acts = []
    for k in range(len(levels)):
        u = np.zeros((T_act, 4))
        if k < 4:
            fr = 0.4 + 0.2 * k
            u[:, k] = 0.5 * amp * (1 + np.sin(2 * np.pi * fr * tt))
        elif k < 8:
            fr = 0.3 + 0.2 * (k - 4)
            u[:, k - 4] = 0.35 * amp * (1 + np.sin(2 * np.pi * fr * tt
                                                   + np.pi / 3))
        else:
            i, j = (k - 8) % 4, (k - 7) % 4
            u[:, i] = 0.4 * amp * (1 + np.sin(2 * np.pi * 0.5 * tt))
            u[:, j] = 0.4 * amp * (1 + np.sin(2 * np.pi * 0.7 * tt
                                              + rng.uniform(0, 2 * np.pi)))
        acts.append(u)
    return levels, hold_t, decay_t, tt, acts, rng


def sysid_data(plant, Hf, levels, acts, hold_t, decay_t, dt, cache_f, fresh,
               log):
    """The decays and actuated runs, from cache_f unless fresh (then
    simulated and cached)."""
    if os.path.exists(cache_f) and not fresh:
        with open(cache_f, "rb") as f:
            blob = pickle.load(f)
        log("sysid data loaded from cache")
        return blob["decays"], blob["acts"]
    from soft_robot_control_tpu_torch.tasks.sysid_export import (
        collect_actuated_trajectories, collect_decay_trajectories)

    decays = collect_decay_trajectories(plant, Hf, levels, hold_time=hold_t,
                                        decay_time=decay_t, dt=dt)
    acts_data = collect_actuated_trajectories(plant, Hf, acts, dt=dt)
    with open(cache_f, "wb") as f:
        pickle.dump({"decays": decays, "acts": acts_data}, f)
    log("sysid data collected + cached")
    return decays, acts_data


def held_out_rel(model, plant, Hf, u_tests, dt, step=None):
    """The mean relative RMS of the model's tip prediction on held-out
    actuated runs (the tip error over the run's largest excursion).
    `step(x, u)` steps the reduced state one by one; by default the
    model's rollout runs the whole input."""
    from soft_robot_control_tpu_torch.tasks.sysid_export import (
        collect_actuated_trajectories)

    t = lambda a: torch.as_tensor(a, dtype=model.dtype, device=model.device)
    z_ref = to_numpy(model.z_ref)
    rels = []
    for z_true, u_test in collect_actuated_trajectories(plant, Hf, u_tests,
                                                        dt=dt):
        x0 = model.observed_to_reduced(t(z_true[0] - z_ref))
        if step is None:
            xs, _ = model.rollout(x0, t(u_test[:-1]), dt)
        else:
            xs = [x0]
            for u in u_test[:-1]:
                xs.append(step(xs[-1], t(u)))
            xs = torch.stack(xs)
        z_pred = to_numpy(model.reduced_to_observed(xs)) + z_ref
        err = np.linalg.norm(z_pred[:, :3] - z_true[:, :3], axis=1)
        motion = np.linalg.norm(z_true[:, :3] - z_true[0, :3], axis=1)
        rels.append(float(np.sqrt(np.mean(err ** 2))
                          / max(motion.max(), 1e-9)))
    return float(np.mean(rels)), rels


def contracts(model, z0, steps, dt):
    """(|x_0|, |x_T|, finite and shrinking) of the unforced reduced
    dynamics from the observed z0 over `steps` steps."""
    x0 = model.observed_to_reduced(torch.as_tensor(
        z0, dtype=model.dtype, device=model.device))
    xs, _ = model.rollout(x0, torch.zeros((steps, model.input_dim),
                                          dtype=model.dtype,
                                          device=model.device), dt)
    n0 = float(torch.linalg.norm(xs[0]))
    nT = float(torch.linalg.norm(xs[-1]))
    return n0, nT, bool(np.isfinite(nT) and nT < n0)


def main(argv=None, stage=None):
    """The campaign on argv's flags: the loop's summary (None with
    --skip-mpc). `stage(name, fn)` runs each stage (sysid_data, learn_ssm,
    held_out_rel, run_closed_loop), fn() by default."""
    args = parser().parse_args(argv)
    stage = stage or (lambda name, fn: fn())
    from soft_robot_control_tpu_torch.models import ssm as ssm_mod
    from soft_robot_control_tpu_torch.models.ssm_learn import (learn_ssm,
                                                               save_mat)
    from soft_robot_control_tpu_torch.robots.robots import DiamondTetRobot

    dev = resolve_device(args.device)
    dtype = run_dtype(dev)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time()-t0:6.1f}s] {msg}", flush=True)

    robot = DiamondTetRobot(device=dev, dtype=dtype)
    plant = robot.plant
    log(f"Diamond tet plant: {plant.n_nodes} nodes, state dim "
        f"{plant.state_dim}, {plant.input_dim} cables; device {dev}")
    os.makedirs(args.out, exist_ok=True)
    Hf = tip_qv_output(plant.n_nodes, TIP)
    dt = robot.dt
    art_path = os.path.join(args.out, "diamond_SSM_model.mat")

    def load_accepted():
        return ssm_mod.from_mat(art_path, None, discrete=False,
                                discr_method="be", dtype=dtype, device=dev)

    if args.mpc_only:
        if not os.path.exists(art_path):
            raise SystemExit("--mpc-only needs a previously accepted "
                             "diamond_SSM_model.mat")
        return run_mpc(args, robot, plant, load_accepted(), Hf, TIP, dt, t0,
                       None, True, stage)

    levels, hold_t, decay_t, tt, acts, rng = levels_and_inputs(
        args.amp, dt, args.quick)
    decays, acts_data = stage("sysid_data", lambda: sysid_data(
        plant, Hf, levels, acts, hold_t, decay_t, dt,
        os.path.join(args.out, "ssm_sysid_data.pkl"), args.fresh_data, log))
    z_eq = Hf @ to_numpy(plant.x_rest())
    model = stage("learn_ssm", lambda: learn_ssm(
        [z[5:] for _, z in decays], dt, state_dim=args.state_dim,
        SSM_order=args.ssm_order, ROM_order=args.rom_order, n_delay=0,
        z_ref=z_eq, actuated_trajs=[z for z, _ in acts_data],
        input_trajs=[u for _, u in acts_data],
        ridge=[1e-8, 1e-6, 1e-4, 1e-2], joint_fit=True, dtype=dtype,
        device=dev))
    log(f"SSM trained: state_dim {model.state_dim}")

    # gate 1: an unforced decay contracts
    n0, nT, stable = contracts(
        model, np.concatenate([3.0 * np.ones(3), np.zeros(3)]), 200, dt)
    log(f"stability gate: |x| {n0:.3f} -> {nT:.3f} over 200 unforced steps "
        f"-> {'PASS' if stable else 'FAIL'}")

    # gate 2: held-out actuated fidelity (one batch as large as the decays')
    u_tests = [0.4 * args.amp * (1 + np.sin(
        2 * np.pi * 0.45 * tt[:, None]
        + rng.uniform(0, 2 * np.pi, 4)[None, :])) for _ in levels]
    rel, rels = stage("held_out_rel", lambda: held_out_rel(
        model, plant, Hf, u_tests, dt))
    log(f"held-out actuated tip prediction rel RMS mean {rel:.3f} over "
        f"{len(rels)} runs ({['%.3f' % r for r in rels]})")

    if stable and rel < 0.5:
        save_mat(model, art_path)
        log("gates PASS -> saved diamond_SSM_model.mat")
        # controlled with backward Euler from the saved file: forward Euler
        # of the cubic reduced dynamics at the control dt (0.02)
        # destabilizes the solver's linearization rollouts
        model = load_accepted()
    else:
        rej = os.path.join(args.out, "diamond_SSM_model.rejected.mat")
        save_mat(model, rej)
        log(f"gates FAIL (stable={stable}, held-out rel {rel:.3f}) -> "
            f"artifact NOT persisted; fit written to {os.path.basename(rej)}")
        if not os.path.exists(art_path):
            raise SystemExit(1)
        model = load_accepted()
        log("continuing MPC with the previously accepted artifact")

    if args.skip_mpc:
        return None
    return run_mpc(args, robot, plant, model, Hf, TIP, dt, t0, rel, stable,
                   stage)


def run_mpc(args, robot, plant, model, Hf, tip, dt, t0, rel, stable,
            stage=None):
    """The closed-loop SSM MPC on the tet plant in the reference's
    configuration: control dt 0.02 (2 plant steps), N=3, N_replan=2,
    Qz=diag(100,100,0,...), R=1e-5, the figure-8 about rest
    (diamond_SSM.py:195-218, 281-282, 355-361). Writes
    diamond_ssm_mpc_sim.pkl and diamond_ssm_mpc.json; returns the summary.
    `stage` runs the loop as main's does."""
    from soft_robot_control_tpu_torch.control.mpc import scp_ssm
    from soft_robot_control_tpu_torch.control.service import GuSTOService
    from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
    from soft_robot_control_tpu_torch.models.interfaces import SSMGuSTO
    from soft_robot_control_tpu_torch.sim.closed_loop import run_closed_loop
    from soft_robot_control_tpu_torch.tasks.recipes import _host, _Lin
    from soft_robot_control_tpu_torch.utils.io import save_data

    dtype_name = "float64" if plant.dtype == torch.float64 else "float32"
    nz = model.output_dim
    dt_c = 2 * dt
    t_target = np.arange(0, max(args.sim_duration + 4.0, 10.0), dt)
    th = 2 * np.pi * t_target / 10.0
    z_target = np.zeros((len(t_target), nz))
    z_target[:, 0] = -15.0 * np.sin(th)
    z_target[:, 1] = 15.0 * np.sin(2 * th)
    Qz = np.zeros((nz, nz))
    Qz[0, 0] = Qz[1, 1] = 100.0
    # one LOCP a query, condensed, trust region off (as the TPWL campaign)
    service = GuSTOService(SSMGuSTO(model), N=3, dt=dt_c, Qz=Qz,
                           R=1e-5 * np.eye(model.input_dim),
                           x0=np.zeros(model.state_dim), t=t_target,
                           z=z_target,
                           U=HyperRectangle(robot.u_max * np.ones(4),
                                            np.zeros(4)),
                           verbose=0, max_gusto_iters=0, convg_thresh=1e-3,
                           locp_backend="condensed", is_tr_active=False,
                           dtype=plant.dtype)
    controller = scp_ssm(model, None, dt_c, N_replan=2, delay=1.0, wait=True,
                         solver_service=service)
    Cf = robot.get_measurement_model(nodes=[tip])
    stage = stage or (lambda name, fn: fn())
    sim = _host(stage("run_closed_loop", lambda: run_closed_loop(
        plant, controller, sim_duration=args.sim_duration, dt=dt,
        measurement_model=_Lin(Cf, plant.device),
        output_model=_Lin(Hf, plant.device))))
    z = np.asarray(sim["z"])  # [q_tip; v_tip]
    t = np.asarray(sim["t"])
    zs = z[:, :2] - to_numpy(model.z_ref)[:2]
    mask = t > 2.0
    # the plan clock is sim_time - delay: scored against the delayed
    # target, the unshifted RMSE beside it
    delay = 1.0
    zx = np.interp(t[mask] - delay, t_target, z_target[:, 0])
    zy = np.interp(t[mask] - delay, t_target, z_target[:, 1])
    rmse = float(np.sqrt(np.mean(np.hypot(zs[mask, 0] - zx,
                                          zs[mask, 1] - zy) ** 2)))
    zx0 = np.interp(t[mask], t_target, z_target[:, 0])
    zy0 = np.interp(t[mask], t_target, z_target[:, 1])
    rmse_unshifted = float(np.sqrt(np.mean(
        np.hypot(zs[mask, 0] - zx0, zs[mask, 1] - zy0) ** 2)))
    print(f"[{time.time()-t0:6.1f}s] Diamond SSM MPC on tet plant: tracking "
          f"RMSE {rmse:.2f} mm vs the delay-shifted target "
          f"({rmse_unshifted:.2f} unshifted; figure-8 amp 15 mm)", flush=True)
    save_data(os.path.join(args.out, "diamond_ssm_mpc_sim.pkl"), sim)
    res = {"tracking_rmse_mm": rmse,
           "tracking_rmse_unshifted_mm": rmse_unshifted,
           "delay_s": delay, "figure8_amp_mm": 15.0,
           "held_out_rel": rel, "stable": stable,
           "sim_duration_s": args.sim_duration, "platform": dtype_name}
    with open(os.path.join(args.out, "diamond_ssm_mpc.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
