"""Task recipes, the user's API (examples/* of the reference; the JAX
package's tasks/recipes.py): collect POD data, compute the POD basis,
collect the TPWL dictionary, check the rollout against the plant, and the
closed-loop recipes (GuSTO MPC, iLQR, open-loop GuSTO with a replay,
ROMPC, Koopman MPC), with the surrogate or tet-FEM plant in place of SOFA.

Every recipe writes its artifacts in the reference's formats (snapshot
pkl, POD pkl, TPWL dict pkl, sim pkl), so data interchanges with the
reference pipeline and the JAX package, and returns its results. The
plant runs on the robot's device; the TPWL model is loaded onto it, so its
nearest-point lookups (the rollout check, the MPC's queries, the EKF)
launch the TPWL select kernel there. Excitation sequences, the SVD and the
dictionary's selection stay numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.core.types import QuadraticCost, Target
from soft_robot_control_tpu_torch.models import tpwl_build
from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
from soft_robot_control_tpu_torch.models.tpwl import TPWLModel, from_tpwl_dict
from soft_robot_control_tpu_torch.rom import pod
from soft_robot_control_tpu_torch.sim.closed_loop import run_closed_loop
from soft_robot_control_tpu_torch.sim.fem_surrogate import simulate_chunked
from soft_robot_control_tpu_torch.utils.device import to_numpy
from soft_robot_control_tpu_torch.utils.io import save_data

DIST_WEIGHTS = {"q": 10.0, "v": 1.0}


# ---------------------------------------------------------------------------
# Offline data collection


def _lhs_excitation(robot, nbr_samples, t_step, seed, amplitude_scale,
                    traj=()):
    """LHS input sequence(s) at one or several amplitude scales, then the
    robot's trajectory-tracking primitives; numpy (T, m) and the times.

    amplitude_scale is a float or a list of floats: one LHS sequence per
    scale (seeds seed, seed + 1, ...) concatenated, so the data covers the
    small deflections the control tasks live in and the larger envelope.
    traj is a sequence of (amplitude, period) pairs, each appending the
    robot's traj_tracking excitation at that cable amplitude and period
    (the reference's Trunk collection mixes LHS with traj_tracking,
    examples/trunk/trunk.py:104-112,186-192)."""
    s = robot.sequences
    scales = (list(amplitude_scale)
              if isinstance(amplitude_scale, (list, tuple))
              else [float(amplitude_scale)])
    umax_save = np.asarray(s.umax).copy()
    us, ts = [], []
    t_off = 0.0
    try:
        for i, sc in enumerate(scales):
            s.umax = sc * umax_save
            u_seq, _, t_seq = s.lhs_sequence(nbr_samples=nbr_samples,
                                             t_step=t_step, seed=seed + i)
            us.append(np.asarray(u_seq).T)
            ts.append(np.asarray(t_seq, float) + t_off)
            t_off = ts[-1][-1] + robot.dt if len(ts[-1]) else t_off
    finally:
        s.umax = umax_save  # don't leak the scaled amplitude to later recipes
    for amp, period in traj:
        u_seq, _, t_seq = s.traj_tracking(amplitude=float(amp),
                                          period=float(period))
        us.append(np.asarray(u_seq).T)
        ts.append(np.asarray(t_seq, float) + t_off)
        t_off = ts[-1][-1] + robot.dt if len(ts[-1]) else t_off
    return np.concatenate(us, axis=0), np.concatenate(ts)


def _sweep(robot, u):
    """The plant from rest under u (T, m) on its device: (T+1, 2n)."""
    return simulate_chunked(robot.plant, robot.plant.x_rest(), u, robot.dt)


def collect_pod_data(robot, save_dir: str, nbr_samples: int = 40,
                     t_step: float = 0.3, seed: int = 111,
                     amplitude_scale=1.0, traj=()):
    """Open-loop LHS excitation, snapshot collection and the rest state,
    the collect_POD_data recipe (examples/diamond/diamond.py:73-113).
    Saves pod_snapshots.pkl (SnapshotData layout, numpy) and rest.pkl."""
    os.makedirs(save_dir, exist_ok=True)
    u, t_seq = _lhs_excitation(robot, nbr_samples, t_step, seed,
                               amplitude_scale, traj=traj)
    X = to_numpy(_sweep(robot, u))
    n = robot.plant.n_nodes_dof
    snap = {
        "t": t_seq, "q": list(X[:-1, n:]), "v": list(X[:-1, :n]),
        "u": list(u), "q+": list(X[1:, n:]), "v+": list(X[1:, :n]),
        "dt": robot.dt,
    }
    save_data(os.path.join(save_dir, "pod_snapshots.pkl"), snap)
    save_data(os.path.join(save_dir, "rest.pkl"),
              {"rest": to_numpy(robot.plant.q_rest)})
    return snap


def compute_pod_basis(save_dir: str, pod_tolerance: float = 5e-5,
                      pod_type: str = "a", rom_dim: Optional[int] = None):
    """SVD POD of the collected snapshots (compute_POD_basis,
    examples/diamond/diamond.py:116-137). Saves pod_model.pkl."""
    cfg = pod.pod_config()
    cfg.pod_tolerance = pod_tolerance
    cfg.pod_type = pod_type
    return pod.run_POD(os.path.join(save_dir, "pod_snapshots.pkl"),
                       os.path.join(save_dir, "pod_model.pkl"), cfg,
                       rom_dim=rom_dim)


def collect_tpwl_data(robot, save_dir: str, threshold: float = 0.5,
                      nbr_samples: int = 40, t_step: float = 0.3,
                      seed: int = 222, discr_method: str = "be",
                      dynamics: str = "continuous",
                      amplitude_scale=1.0, traj=(),
                      eval_type: str = "distance"):
    """Build the TPWL dictionary along a fresh excitation trajectory
    (collect_TPWL_data, examples/diamond/diamond.py:140-191) on the
    robot's device. Saves tpwl_model_snapshots.pkl in the reference dict
    layout.

    dynamics='discrete' stores the projected implicit-step map as well
    (tpwl_utils.py:279-289); eval_type='dynamics' adds points where the
    partial dictionary's one-step prediction error reaches the threshold
    instead of by state distance (tpwl_utils.py:199-260)."""
    dev = robot.plant.device
    rom = pod.load_POD(os.path.join(save_dir, "pod_model.pkl"), device=dev)
    u, _ = _lhs_excitation(robot, nbr_samples, t_step, seed, amplitude_scale,
                           traj=traj)
    X = _sweep(robot, u)
    cfg = tpwl_build.tpwl_config(TPWL_threshold=threshold,
                                 TPWL_weighting_factors=dict(DIST_WEIGHTS),
                                 eval_type=eval_type, dt=robot.dt)
    model = tpwl_build.build_tpwl_model(
        robot.plant, rom, X[:-1], u, config=cfg,
        Cf=robot.get_measurement_model(), Hf=robot.get_output_model(),
        params={"dist_weights": dict(DIST_WEIGHTS)},
        discr_method=discr_method, dynamics=dynamics, x_next=X[1:],
        dt=robot.dt, device=dev)
    save_data(os.path.join(save_dir, "tpwl_model_snapshots.pkl"),
              tpwl_build.to_tpwl_dict(model))
    return model


def load_tpwl(robot, save_dir: str, discr_method: str = "be") -> TPWLModel:
    """The saved dictionary on the robot's device, with the robot's
    measurement and output models."""
    return from_tpwl_dict(os.path.join(save_dir, "tpwl_model_snapshots.pkl"),
                          params={"dist_weights": dict(DIST_WEIGHTS)},
                          Cf=robot.get_measurement_model(),
                          Hf=robot.get_output_model(),
                          discr_method=discr_method,
                          device=robot.plant.device)


# ---------------------------------------------------------------------------
# Model validation


def tpwl_rollout_check(robot, save_dir: str, nbr_samples: int = 10,
                       seed: int = 333, t_step: float = 0.4,
                       amplitude_scale: float = 1.0, traj=None):
    """Open-loop ROM fidelity against the plant, with MSE: the TPWL_rollout
    module test (examples/hardware/diamond.py:20-73). Also reports
    `rel_err`, the z error over the motion's. The ROM steps through
    `TPWLModel.rollout`, one launch of the select kernel a step.

    traj=(amplitude, period) scores fidelity on a held-out figure-8
    ("infinity sign") excitation instead of LHS."""
    model = load_tpwl(robot, save_dir).pre_discretize(robot.dt)
    if isinstance(amplitude_scale, (list, tuple)):
        # scored at the largest training scale: the envelope the
        # dictionary must cover
        amplitude_scale = max(amplitude_scale)
    s = robot.sequences
    if traj is not None:
        u_seq, _, _ = s.traj_tracking(amplitude=float(traj[0]),
                                      period=float(traj[1]))
    else:
        umax_save = np.asarray(s.umax).copy()
        s.umax = amplitude_scale * umax_save
        try:
            u_seq, _, _ = s.lhs_sequence(nbr_samples=nbr_samples,
                                         t_step=t_step, seed=seed)
        finally:
            s.umax = umax_save
    u = np.asarray(u_seq).T
    X = _sweep(robot, u)
    Hf = robot.get_output_model()
    z_true = to_numpy(X) @ Hf.T
    x0 = model.rom.project_x(X[0])
    _, z = model.rollout(x0, u, robot.dt)
    z = to_numpy(z)
    T = min(len(z), len(z_true))
    mse = float(np.mean(np.sum((z[:T] - z_true[:T]) ** 2, axis=1)))
    rel = float(np.linalg.norm(z[:T] - z_true[:T])
                / max(np.linalg.norm(z_true - z_true.mean(0)), 1e-12))
    return {"mse": mse, "rel_err": rel, "z_rom": z, "z_true": z_true}


# ---------------------------------------------------------------------------
# Closed-loop control recipes


def run_scp(robot, save_dir: str, t_target, z_target, dt_solver=None, N=5,
            N_replan=2, Qz=None, R=None, sim_duration=6.0, delay=1.0,
            U=None, dU=None, save_prefix="scp", u_sat=None, feedback=True,
            feedback_R=None, ekf_W_scale=1.0, **gusto_kwargs):
    """GuSTO SCP MPC closed loop with the EKF, the run_scp +
    run_gusto_solver recipe pair (examples/diamond/diamond.py:194-316)
    with the solver in-process, on the robot's device. Saves
    {save_prefix}_sim.pkl."""
    from soft_robot_control_tpu_torch.control.mpc import scp
    from soft_robot_control_tpu_torch.control.service import GuSTOService
    from soft_robot_control_tpu_torch.estimators.ekf import DiscreteEKFObserver

    dt = robot.dt
    dt_solver = dt_solver or 2 * dt
    model = load_tpwl(robot, save_dir).pre_discretize(dt)
    gmodel = TPWLGuSTO(model)
    Hf = robot.get_output_model()
    nz = Hf.shape[0]
    Qz = Qz if Qz is not None else 100.0 * np.eye(nz)
    R = R if R is not None else 1e-3 * np.eye(robot.n_cables)

    x0 = to_numpy(model.rom.project_x(model.rom.x_ref))
    # the solver works in shifted output coordinates z = H x_r: absolute
    # targets are shifted by z_ref first, as the reference's
    # z = model.zfyf_to_zy(zf=zf_target) (examples/diamond/diamond.py:283)
    z_solver = to_numpy(model.zfyf_to_zy(zf=z_target))
    service = GuSTOService(gmodel, N, dt_solver, Qz, R, x0, t=t_target,
                           z=z_solver, U=U, dU=dU,
                           max_gusto_iters=gusto_kwargs.pop("max_gusto_iters", 5),
                           convg_thresh=gusto_kwargs.pop("convg_thresh", 1e-2),
                           **gusto_kwargs)

    H = to_numpy(model.H)
    cost = QuadraticCost(Q=H.T @ Qz @ H, R=R)
    dx_char = to_numpy(model.get_characteristic_dx(dt))
    Cf = robot.get_measurement_model()
    # W = diag(dx_char) is the reference's process noise
    # (examples/trunk/trunk.py:252-255); ekf_W_scale scales it and the
    # initial covariance with it
    W_ekf = float(ekf_W_scale) * np.diag(dx_char + 1e-8)
    Sigma0 = None if ekf_W_scale == 1.0 else W_ekf
    observer = DiscreteEKFObserver(model, W=W_ekf, Sigma0=Sigma0,
                                   V=0.1 * np.eye(Cf.shape[0]))
    controller = scp(model, cost, dt, N_replan=N_replan, observer=observer,
                     delay=delay, wait=True, solver_service=service, mpc=True,
                     feedback=feedback, feedback_R=feedback_R)

    sim = _run_and_save(robot, controller, sim_duration, save_dir, save_prefix,
                        u_sat=u_sat)
    if "info" in sim:
        sim["info"]["plan_rejects"] = int(getattr(service.gusto,
                                                  "plan_rejects", 0))
        sim["info"]["reject_log"] = list(getattr(service.gusto,
                                                 "reject_log", []))
        save_data(os.path.join(save_dir, f"{save_prefix}_sim.pkl"), sim)
    return sim


def run_ilqr(robot, save_dir: str, t_target, z_target, Qz=None, R=None,
             Qf=None, sim_duration=6.0, delay=1.0, tf=None,
             save_prefix="ilqr", observer=None, config=None, u_sat=None,
             feedback_R=None):
    """iLQR trajectory optimization and closed-loop tracking (run_ilqr,
    examples/diamond/diamond.py:318-398) on the robot's device. Qf
    defaults to zero like the reference's trajectory-tracking configs
    (trunk.py:374: cost.Qf = np.zeros_like(Qz))."""
    from soft_robot_control_tpu_torch.control.policies import ilqr as ilqr_ctrl

    dt = robot.dt
    model = load_tpwl(robot, save_dir).pre_discretize(dt)
    Hf = robot.get_output_model()
    nz = Hf.shape[0]
    Qz = Qz if Qz is not None else 100.0 * np.eye(nz)
    R = R if R is not None else 1e-2 * np.eye(robot.n_cables)
    cost = QuadraticCost(Q=Qz, R=R, Qf=np.zeros_like(Qz) if Qf is None else Qf)
    target = Target(t=t_target, z=np.asarray(z_target), Hf=Hf)
    controller = ilqr_ctrl(model, cost, target, dt=dt, observer=observer,
                           delay=delay, tf=tf, config=config,
                           feedback_R=feedback_R)
    return _run_and_save(robot, controller, sim_duration, save_dir,
                         save_prefix, u_sat=u_sat)


def run_scp_open_loop(robot, save_dir: str, t_target, z_target, N=100,
                      dt_solver=None, Qz=None, R=None, U=None, dU=None,
                      **kwargs):
    """Open-loop GuSTO trajectory optimization, then its inputs replayed on
    the plant (run_scp_OL, examples/hardware/diamond.py:400-496). Returns
    numpy topt, uopt, zopt, the replay's z and the solver."""
    from soft_robot_control_tpu_torch.scp.standalone import run_gusto_standalone

    dt_solver = dt_solver or 2 * robot.dt
    model = load_tpwl(robot, save_dir).pre_discretize(robot.dt)
    gmodel = TPWLGuSTO(model)
    Hf = robot.get_output_model()
    nz = Hf.shape[0]
    Qz = Qz if Qz is not None else 100.0 * np.eye(nz)
    R = R if R is not None else 1e-3 * np.eye(robot.n_cables)
    x0 = to_numpy(model.rom.project_x(model.rom.x_ref))
    xopt, uopt, zopt, topt, gusto = run_gusto_standalone(
        gmodel, N, dt_solver, Qz, R, x0, t=t_target, z=np.asarray(z_target),
        U=U, dU=dU, **kwargs)
    uopt, zopt, topt = to_numpy(uopt), to_numpy(zopt), to_numpy(topt)
    # the optimized inputs on the plant's grid, held linearly between knots
    t_u = np.arange(0, topt[-1], robot.dt)
    u_replay = np.stack([np.interp(t_u, topt[:-1], uopt[:, j])
                         for j in range(uopt.shape[1])], axis=1)
    X = to_numpy(_sweep(robot, u_replay))
    return {"topt": topt, "uopt": uopt, "zopt": zopt, "z_replay": X @ Hf.T,
            "gusto": gusto}


def run_rompc(robot, save_dir: str, t_target, z_target, N=20, N_replan=4,
              Qz=None, R=None, sim_duration=6.0, delay=1.0,
              save_prefix="rompc", locp_backend="dense", qp_backend="xla"):
    """The ROMPC recipe (examples/diamond/diamond_rompc.py): the first TPWL
    point as an LTI ROM on the robot's device, a Luenberger observer,
    linear MPC and DARE feedback in closed loop.

    locp_backend='condensed' solves the small state-eliminated QP instead
    of the sparse one; with qp_backend='pallas' it runs in the batched ADMM
    kernel."""
    from soft_robot_control_tpu_torch.control.linear_mpc import LinearMPCService
    from soft_robot_control_tpu_torch.control.rompc import ROMPC
    from soft_robot_control_tpu_torch.models.linear import (LinearROM,
                                                            tpwl_to_linear_rom)

    dt = robot.dt
    lin_data = tpwl_to_linear_rom(os.path.join(save_dir,
                                               "tpwl_model_snapshots.pkl"))
    lin = LinearROM(lin_data, dt, Cf=robot.get_measurement_model(),
                    Hf=robot.get_output_model(), device=robot.plant.device)
    H = to_numpy(lin.H)
    nz = H.shape[0]
    Qz = Qz if Qz is not None else 100.0 * np.eye(nz)
    R = R if R is not None else 1e-2 * np.eye(robot.n_cables)
    # targets shifted into the ROM's z coordinates
    z_shift = np.asarray(z_target) - to_numpy(lin.z_ref)
    target = Target(t=t_target, z=z_shift)
    svc = LinearMPCService(lin, N, dt, QuadraticCost(Q=Qz, R=R, Qf=10.0 * Qz),
                           target, locp_backend=locp_backend,
                           qp_backend=qp_backend)
    nx, ny = lin.state_dim, to_numpy(lin.C).shape[0]
    ctrl = ROMPC(lin, QuadraticCost(Q=H.T @ Qz @ H, R=R),
                 QuadraticCost(Q=np.eye(nx), R=np.eye(ny)), dt,
                 N_replan=N_replan, delay=delay, wait=True,
                 solver_service=svc)
    return _run_and_save(robot, ctrl, sim_duration, save_dir, save_prefix)


def _delay_rows(yn, un, d):
    """The delay-embedded rows [y_t, y_{t-1}, ..., y_{t-d}, u_{t-1}, ...,
    u_{t-d}] for t = d .. T-1 (T = len(yn)), one row a t."""
    T = len(yn)
    return np.concatenate([yn[d:T]]
                          + [yn[d - j - 1:T - j - 1] for j in range(d)]
                          + [un[d - j - 1:T - j - 1] for j in range(d)],
                          axis=1)


def run_koopman(robot, save_dir: str, t_target, z_target_scaled, delay_embed=2,
                degree=2, N=8, rollout_horizon=4, Qz=None, R=None,
                sim_duration=8.0, delay=1.0, nbr_samples=120,
                save_prefix="koopman", absolute_targets=False,
                locp_backend="dense", qp_backend="xla"):
    """The native Koopman recipe (run_koopman, examples/diamond/
    diamond_koopman.py with the MATLAB training replaced by EDMD): collect
    data on the plant, scale, train, constrained lifted MPC, closed loop;
    the outputs are the robot's default output nodes.

    The lifted MPC tracks targets in the training-scaled output
    coordinates (the reference rescales targets with KoopmanScaling);
    absolute_targets=True takes absolute outputs and normalizes them with
    the scaling computed from the training data here."""
    from soft_robot_control_tpu_torch.control.koopman import KoopmanMPC
    from soft_robot_control_tpu_torch.control.linear_mpc import LinearMPCService
    from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
    from soft_robot_control_tpu_torch.models.koopman import (
        koopman_model_from_arrays, train_edmd)

    dt = robot.dt
    dev = robot.plant.device
    m_in = robot.n_cables
    s = robot.sequences
    u_seq, _, _ = s.lhs_sequence(nbr_samples=nbr_samples, t_step=0.25,
                                 seed=444)
    u_train = np.asarray(u_seq).T
    X = to_numpy(_sweep(robot, u_train))
    Hf = robot.get_output_model()
    y_train = X[:-1] @ Hf.T
    ny = y_train.shape[1]
    y_off = y_train.mean(axis=0)
    y_fac = np.maximum(np.abs(y_train - y_off).max(axis=0), 1e-9)
    u_fac = np.maximum(np.abs(u_train).max(axis=0), 1e-9)
    yn = (y_train - y_off) / y_fac
    un = u_train / u_fac
    d = delay_embed
    nzeta = ny * (d + 1) + m_in * d
    zeta = _delay_rows(yn, un, d)
    A, B, C = train_edmd(zeta, un[d:], degree=degree, reg=1e-8, device=dev)
    km = koopman_model_from_arrays(
        A, B, C[:ny], n=ny, m=m_in, nzeta=nzeta, delays=d,
        obs_degree=degree, Ts=dt,
        scale_dict={"y_offset": y_off, "y_factor": y_fac,
                    "u_offset": np.zeros(m_in), "u_factor": u_fac},
        device=dev)

    Qz = Qz if Qz is not None else 100.0 * np.eye(ny)
    R = R if R is not None else 1e-1 * np.eye(m_in)
    z_t = np.asarray(z_target_scaled)
    if absolute_targets:
        z_t = (z_t - y_off) / y_fac
    target = Target(t=t_target, z=z_t)
    U = HyperRectangle(np.ones(m_in), np.zeros(m_in))
    dU = HyperRectangle(0.08 * np.ones(m_in), -0.08 * np.ones(m_in))
    # the dU-constrained lifted QP needs a larger fixed ADMM budget than
    # ROMPC's box QP (the dense path gets max_iter=2000 for the same
    # reason); cold-start failures fall back to the host adapter
    svc = LinearMPCService(km, N, dt, QuadraticCost(Q=Qz, R=R, Qf=5 * Qz),
                           target, U=U, dU=dU, max_iter=2000,
                           locp_backend=locp_backend, qp_backend=qp_backend,
                           qp_iters=600, rho_stages=6)
    ctrl = KoopmanMPC(km, delay=delay, wait=True, solver_service=svc,
                      rollout_horizon=rollout_horizon)
    # the Koopman model lives in output coordinates: the controller is fed
    # the performance output y = Hf x (the reference measures exactly the
    # output nodes, diamond_koopman.py:180-195), not the full measurement
    return _run_and_save(robot, ctrl, sim_duration, save_dir, save_prefix,
                         measurement_matrix=Hf)


# ---------------------------------------------------------------------------


class _Lin:
    """A measurement or output model y = M x on the plant's device."""

    def __init__(self, M, device):
        self.M = torch.as_tensor(np.array(M), device=device)

    def evaluate(self, x, generator=None):
        return self.M.to(x.dtype) @ x


def _run_and_save(robot, controller, sim_duration, save_dir, save_prefix,
                  measurement_matrix=None, u_sat=None):
    """The closed loop on the robot's plant, saved as
    {save_prefix}_sim.pkl. u_sat bounds the applied command below the
    actuator limit, the deployment-side guard that keeps the loop inside
    the model's training envelope: the plan's QP bound (U) cannot see the
    LQR feedback term u_bar + K (x_hat - x_bar)."""
    Hf = robot.get_output_model()
    Cf = robot.get_measurement_model() if measurement_matrix is None \
        else measurement_matrix
    dev = robot.plant.device
    m = robot.plant.input_dim
    u_hi = robot.u_max if u_sat is None else min(u_sat, robot.u_max)
    sim = run_closed_loop(robot.plant, controller, sim_duration=sim_duration,
                          dt=robot.dt, measurement_model=_Lin(Cf, dev),
                          output_model=_Lin(Hf, dev),
                          u_limits=(robot.u_min * np.ones(m),
                                    u_hi * np.ones(m)))
    sim = _host(sim)
    if save_dir is not None:
        save_data(os.path.join(save_dir, f"{save_prefix}_sim.pkl"), sim)
    return sim


def _host(obj):
    """obj with every tensor in it, through dicts and lists, as a numpy
    array: a pickled run holds no tensor, so that either package reads
    it."""
    if torch.is_tensor(obj):
        return to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_host(v) for v in obj]
    return obj
