"""Modal analysis: mode shapes of the plant and batched decay simulations
(port of the JAX package's sim/modal.py).

Capability parity with launch_sofa_modal_analysis.py: compute structural
mode shapes, build initial conditions as mode shape x amplitude x sign
combinations, simulate the free decay of each, and save per-case decay
trajectories with crude resume (already-produced cases are skipped,
launch_sofa_modal_analysis.py:253-256).

All cases run as ONE batched simulation on the plant's device (each step
one batched plant step); the eigendecomposition and the files are numpy on
the host, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from soft_robot_control_tpu_torch.sim.fem_surrogate import (FEMSurrogate,
                                                            simulate_batch)
from soft_robot_control_tpu_torch.sim.fem_tet import REFERENCE_ROOT
from soft_robot_control_tpu_torch.utils.device import to_numpy
from soft_robot_control_tpu_torch.utils.io import load_data, save_data


def mode_shapes(plant: FEMSurrogate, n_modes: Optional[int] = None):
    """Undamped structural modes of the plant: solve K phi = w^2 M phi.

    Returns (frequencies_rad, modes (n, n_modes)), ascending frequency, as
    numpy arrays: the role of the reference's MATLAB-exported mode1-3.mat
    vectors (robots/data/, used by launch_sofa_modal_analysis.py:96-126).
    """
    K = to_numpy(plant.K0 if hasattr(plant, "K0") else plant.K).astype(float)
    if hasattr(plant, "free_mask"):  # restrict to free dofs (Dirichlet base)
        free = to_numpy(plant.free_mask) > 0
        Kf = K[np.ix_(free, free)]
        m = float(plant.m_node)
        w2f, phif = np.linalg.eigh(Kf / m)
        phi_full = np.zeros((K.shape[0], phif.shape[1]))
        phi_full[free] = phif
        order = np.argsort(np.maximum(w2f, 0.0))
        w = np.sqrt(np.maximum(w2f, 0.0)[order])
        phi = phi_full[:, order]
        if n_modes is not None:
            w, phi = w[:n_modes], phi[:, :n_modes]
        return w, phi
    m = float(plant.m_node)
    w2, phi = np.linalg.eigh(K / m)
    w2 = np.maximum(w2, 0.0)
    order = np.argsort(w2)
    w = np.sqrt(w2[order])
    phi = phi[:, order]
    if n_modes is not None:
        w, phi = w[:n_modes], phi[:, :n_modes]
    return w, phi


def modal_decay_batch(plant: FEMSurrogate, modes, amplitudes: Sequence[float],
                      signs: Sequence[float] = (1.0, -1.0),
                      duration: float = 3.0, dt: float = 0.01,
                      save_dir: Optional[str] = None):
    """Simulate free decay from q = q_rest + sign * amp * mode for every
    (mode, amplitude, sign) combination, as one batched simulation.

    Returns dict case_name -> trajectory (T+1, 2n), numpy. With save_dir
    set, each case is written to <case>.pkl and existing files are
    skipped.
    """
    modes = np.atleast_2d(np.asarray(modes, float))
    if modes.shape[0] == plant.n_nodes_dof and modes.shape[1] != plant.n_nodes_dof:
        modes = modes.T
    q_rest = to_numpy(plant.q_rest)
    cases = []
    ics = []
    for mi, mode in enumerate(modes):
        for amp in amplitudes:
            for sign in signs:
                name = f"mode{mi + 1}_amp{amp:g}_sign{int(np.sign(sign))}"
                if save_dir is not None and os.path.isfile(
                        os.path.join(save_dir, name + ".pkl")):
                    continue  # crude resume
                q0 = q_rest + sign * amp * mode
                ics.append(np.concatenate((np.zeros_like(q0), q0)))
                cases.append(name)

    results = {}
    if cases:
        N = int(duration / dt)
        x0 = torch.as_tensor(np.stack(ics), dtype=plant.dtype,
                             device=plant.device)
        u = torch.zeros((len(cases), N, plant.input_dim), dtype=plant.dtype,
                        device=plant.device)
        X = to_numpy(simulate_batch(plant, x0, u, dt))
        for name, traj in zip(cases, X):
            results[name] = traj
            if save_dir is not None:
                os.makedirs(save_dir, exist_ok=True)
                n = plant.n_nodes_dof
                save_data(os.path.join(save_dir, name + ".pkl"),
                          {"t": dt * np.arange(traj.shape[0]),
                           "q": traj[:, n:], "v": traj[:, :n], "dt": dt})
    # load any previously produced cases
    if save_dir is not None and os.path.isdir(save_dir):
        for f in os.listdir(save_dir):
            if f.endswith(".pkl"):
                name = f[:-4]
                if name not in results and name.startswith("mode"):
                    data = load_data(os.path.join(save_dir, f))
                    results[name] = np.concatenate(
                        (np.asarray(data["v"]), np.asarray(data["q"])), axis=1)
    return results


REFERENCE_MODE_DIR = os.path.join(REFERENCE_ROOT, "robots", "data")


def load_reference_modes(mode_dir: str = None, transform: bool = True):
    """Load the shipped Diamond mode-shape vectors mode1-3.mat
    (robots/data/, each (3, 1628) per-node displacement), flattened to
    (4884,) and rotated into the Diamond scene frame (the loader applies
    rotation [90,0,0]; displacement vectors rotate, translations don't),
    ready to drive `modal_decay_batch` as launch_sofa_modal_analysis.py:
    96-126 uses them with q0 * scale_mode."""
    import scipy.io as sio

    mode_dir = mode_dir or REFERENCE_MODE_DIR
    modes = []
    for i in (1, 2, 3):
        m = sio.loadmat(os.path.join(mode_dir, f"mode{i}.mat"))
        vec = np.asarray(m[f"mode{i}"], float)          # (3, n_nodes)
        if transform:
            R = np.array([[1.0, 0.0, 0.0],
                          [0.0, 0.0, -1.0],
                          [0.0, 1.0, 0.0]])             # Rx(90 deg)
            vec = R @ vec
        modes.append(vec.T.reshape(-1))                 # (3 n_nodes,)
    return np.stack(modes)
