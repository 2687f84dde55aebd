"""Calibration recipes (examples/hardware/calibration.py; the JAX
package's tasks/calibration.py): rest calibration (settle to equilibrium),
output-node calibration (the node matching a measured marker), the
per-cable step and sine responses of model calibration, and actuator
calibration (input gains). The "hardware" is any trajectory data, from
the surrogate plant or a real log; the plant runs on its own device and
the fits are numpy on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from soft_robot_control_tpu_torch.sim.fem_surrogate import FEMSurrogate, simulate


def _simulate_np(plant, u, dt):
    """The plant from rest under u (N, m), as a numpy trajectory."""
    return simulate(plant, plant.x_rest(), u, dt).cpu().numpy()


def calibrate_rest(plant: FEMSurrogate, settle_time: float = 5.0,
                   dt: float = 0.01, tol: float = 1e-8):
    """Settle the plant under zero input and return the equilibrium (q, v)
    (calibration.py:53-88); warns when the velocity has not settled to
    `tol`."""
    N = int(settle_time / dt)
    X = _simulate_np(plant, np.zeros((N, plant.input_dim)), dt)
    n = plant.n_nodes_dof
    v_final = X[-1, :n]
    if np.linalg.norm(v_final) > tol * max(1.0, np.linalg.norm(X[-1, n:])):
        print(f"warning: rest not fully settled, |v| = {np.linalg.norm(v_final):.3g}")
    return X[-1, n:], X[-1, :n]


def calibrate_output_node(q_traj, measured, candidate_nodes=None):
    """The node whose position trajectory best matches a measured marker
    trajectory up to a constant offset (calibration.py:15-51).

    q_traj: (T, n) node positions; measured: (T,) or (T, d<=1 here).
    Returns (best_node, mse_per_node)."""
    q_traj = np.asarray(q_traj)
    measured = np.asarray(measured).reshape(len(q_traj), -1)[:, 0]
    nodes = candidate_nodes if candidate_nodes is not None else range(q_traj.shape[1])
    mses = {}
    for node in nodes:
        # allow a constant offset (marker frame mismatch)
        resid = q_traj[:, node] - measured
        resid = resid - resid.mean()
        mses[node] = float(np.mean(resid**2))
    best = min(mses, key=mses.get)
    return best, mses


def collect_calibration_responses(plant: FEMSurrogate, u_max: float,
                                  dt: float = 0.01, t_step: float = 2.0,
                                  t_sine: float = 4.0, sine_period: float = 1.0):
    """Per-cable step and sine responses, the dataset of the
    model-calibration problem (calibration.py:90-177). Returns
    {cable -> {'step': (t, X), 'sine': (t, X)}}, numpy."""
    m = plant.input_dim
    out = {}
    for c in range(m):
        N_s = int(t_step / dt)
        u_step = np.zeros((N_s, m))
        u_step[:, c] = u_max
        X_step = _simulate_np(plant, u_step, dt)
        N_w = int(t_sine / dt)
        t = dt * np.arange(N_w)
        u_sine = np.zeros((N_w, m))
        u_sine[:, c] = u_max * 0.5 * (1 - np.cos(2 * np.pi * t / sine_period))
        X_sine = _simulate_np(plant, u_sine, dt)
        out[c] = {"step": (dt * np.arange(N_s + 1), X_step),
                  "sine": (dt * np.arange(N_w + 1), X_sine)}
    return out


def calibrate_actuator_gains(plant: FEMSurrogate, measured_responses: dict,
                             u_max: float, dt: float = 0.01,
                             output_node: Optional[int] = None):
    """Per-cable input gains g that make the plant's steady step deflections
    match measured ones (calibration.py:179-273).

    measured_responses: {cable -> steady-state deflection of the output
    node under a u_max step}. Returns g (apply by scaling H's columns)."""
    n = plant.n_nodes_dof
    node = output_node if output_node is not None else n - 1
    q_rest = plant.q_rest.cpu().numpy()
    gains = np.ones(plant.input_dim)
    for c, target_defl in measured_responses.items():
        N = int(3.0 / dt)
        u = np.zeros((N, plant.input_dim))
        u[:, c] = u_max
        X = _simulate_np(plant, u, dt)
        sim_defl = X[-1, n + node] - q_rest[node]
        if abs(sim_defl) > 1e-12:
            gains[c] = target_defl / sim_defl
    return gains


def apply_actuator_gains(plant: FEMSurrogate, gains) -> FEMSurrogate:
    """A plant on the same device with H's columns scaled by the gains."""
    H = plant.H * plant.H.new_tensor(np.asarray(gains))[None, :]
    return FEMSurrogate(plant.K, plant.m_node, plant.alpha, plant.beta,
                        plant.gamma, plant.q_rest, H, device=plant.device)
