"""System-identification data: decay and actuated experiments on a plant,
and their export.

The role of the reference's examples/diamond/SSM_sysID.py and
collectData.py (the JAX package's tasks/sysid_export.py): run decay
experiments (hold an input, release, record the observed outputs) and
actuated runs on the plant, export them as CSV in the layout the SSMLearn
MATLAB pipeline reads (one trajectory a file, columns the outputs over
time), convert recorded simulations from pickle to CSV, and fit an SSM
natively (models/ssm_learn.py).

The experiments run as one batched simulation on the plant's device, in
the plant's dtype (its H): every lane a level or input sequence; on the
tet-FEM plant each lane's PCG stops at its own iteration. The outputs are
numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.sim.fem_surrogate import (
    simulate, simulate_batch_chunked)
from soft_robot_control_tpu_torch.utils.device import to_numpy
from soft_robot_control_tpu_torch.utils.io import load_data


def _from_rest(plant, u_seqs, dt):
    """The plant from rest under each of the input sequences u_seqs (B, T,
    m), one batch: numpy (B, T+1, 2n)."""
    x0 = plant.x_rest()[None].repeat(len(u_seqs), 1)
    u = torch.as_tensor(np.asarray(u_seqs, float), dtype=plant.H.dtype,
                        device=plant.H.device)
    return to_numpy(simulate_batch_chunked(plant, x0, u, dt))


def collect_decay_trajectories(plant, Hf, u_levels, hold_time: float = 2.0,
                               decay_time: float = 4.0, dt: float = 0.01):
    """For each input level: hold u until (near) steady state, release
    (u = 0) and record the decay of z = Hf x. All levels go in one batch.

    Returns a list of (t, z) decay trajectories (the SSMLearn training
    format: unforced decays toward the origin of the observed
    coordinates)."""
    Hf = np.asarray(Hf)
    N_hold = int(hold_time / dt)
    N_decay = int(decay_time / dt)
    u_seqs = np.stack([
        np.concatenate([np.tile(np.asarray(u, float), (N_hold, 1)),
                        np.zeros((N_decay, plant.input_dim))], axis=0)
        for u in u_levels])
    X = _from_rest(plant, u_seqs, dt)
    t = dt * np.arange(N_decay + 1)
    return [(t, X[b, N_hold:] @ Hf.T) for b in range(len(u_levels))]


def export_decays_csv(decays, out_dir: str, prefix: str = "decay"):
    """Write each (t, z) decay to <prefix>_<i>.csv with columns [t, z...]."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (t, z) in enumerate(decays):
        path = os.path.join(out_dir, f"{prefix}_{i}.csv")
        np.savetxt(path, np.column_stack([t, z]), delimiter=",")
        paths.append(path)
    return paths


def sim_pkl_to_csv(pkl_path: str, out_dir: Optional[str] = None):
    """Convert a recorded *_sim.pkl into t/u/z CSV files
    (examples/diamond/collectData.py's role)."""
    data = load_data(pkl_path)
    out_dir = out_dir or os.path.dirname(pkl_path)
    base = os.path.splitext(os.path.basename(pkl_path))[0]
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for key in ("t", "u", "z", "z_hat"):
        if key in data and np.asarray(data[key]).size:
            path = os.path.join(out_dir, f"{base}_{key}.csv")
            np.savetxt(path, np.atleast_2d(np.asarray(data[key])),
                       delimiter=",")
            paths[key] = path
    return paths


def collect_actuated_trajectories(plant, Hf, u_seqs, dt: float = 0.01):
    """The plant from rest under each input sequence (T, m), z = Hf x
    recorded: training data for the SSM input-matrix fit
    (models/ssm_learn.py step 6). Sequences of one length go in one batch.
    Returns a list of (z (T, p), u (T, m))."""
    Hf = np.asarray(Hf)
    u_arr = [np.atleast_2d(np.asarray(u, float)) for u in u_seqs]
    if len({u.shape for u in u_arr}) == 1:
        X = _from_rest(plant, np.stack(u_arr), dt)
        return [(X[b, :-1] @ Hf.T, u_arr[b]) for b in range(len(u_arr))]
    out = []
    for u_seq in u_arr:
        X = to_numpy(simulate(plant, plant.x_rest(), u_seq, dt))
        out.append((X[:-1] @ Hf.T, u_seq))
    return out


def train_ssm_native(plant, Hf, u_levels, state_dim: int,
                     SSM_order: int = 3, ROM_order: int = 3,
                     n_delay: int = 0, hold_time: float = 2.0,
                     decay_time: float = 4.0, dt: float = 0.01,
                     settle_skip: int = 0, actuated_inputs=None,
                     save_path: Optional[str] = None, **learn_kwargs):
    """Native SSM identification end to end: the decay campaign on the
    plant, then an SSMModel fitted by models/ssm_learn.py on the plant's
    device (the reference's SSM_sysID.py -> CSV -> MATLAB SSMLearn ->
    SSM_model.mat in one call).

    The equilibrium is the plant's rest state (the role of the reference's
    rest calibration), not an estimate from the decays' tails.
    settle_skip drops the first samples of every decay: right after the
    release the state carries fast off-manifold transients whose
    projection corrupts the reduced-dynamics fit (SSMLearn's t_trunc); a
    model trained so is valid on the manifold, and its predictions should
    start after the transient too. Returns the model; writes an
    SSM_model.mat when save_path is given."""
    from soft_robot_control_tpu_torch.models.ssm_learn import (learn_ssm,
                                                               save_mat)

    decays = collect_decay_trajectories(plant, Hf, u_levels,
                                        hold_time=hold_time,
                                        decay_time=decay_time, dt=dt)
    if actuated_inputs is not None:
        acts = collect_actuated_trajectories(plant, Hf, actuated_inputs,
                                             dt=dt)
        learn_kwargs.setdefault("actuated_trajs", [z for z, _ in acts])
        learn_kwargs.setdefault("input_trajs", [u for _, u in acts])
    Hf = np.asarray(Hf)
    z_eq = Hf @ to_numpy(plant.x_rest())
    if n_delay > 0:
        z_eq = np.tile(z_eq, n_delay + 1)
    learn_kwargs.setdefault("device", plant.H.device)
    model = learn_ssm([z[settle_skip:] for _, z in decays], dt,
                      state_dim=state_dim,
                      SSM_order=SSM_order, ROM_order=ROM_order,
                      n_delay=n_delay, z_ref=z_eq, **learn_kwargs)
    if save_path is not None:
        save_mat(model, save_path)
    return model
