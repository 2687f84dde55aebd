"""Task recipes, the user's API (examples/* of the reference; the JAX
package's tasks/recipes.py): collect POD data, compute the POD basis,
collect the TPWL dictionary, check the rollout against the plant, and the
GuSTO MPC closed loop, with the surrogate plant in place of SOFA.

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

from soft_robot_control_tpu_torch.core.types import QuadraticCost
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
    if save_dir is not None:
        save_data(os.path.join(save_dir, f"{save_prefix}_sim.pkl"), sim)
    return sim
