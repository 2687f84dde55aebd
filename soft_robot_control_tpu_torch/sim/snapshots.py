"""Snapshot capture during open-loop excitation (sofacontrol/utils.py:
19-118 Point/SnapshotData, sofacontrol/open_loop_controller.py:71-205): a
per-step `Point` record, a `SnapshotData` collector with the
save_snapshot/add_point/simulation_end contract, and an open-loop runner
that drives the plant under a sequence, asks the collector whether to save
each point, and, with save_dynamics=True, attaches the plant's analytic
affine dynamics (A, B, d).

The trajectory is simulated on the plant's device; the points are numpy
arrays on the host, as in the JAX package. The Jacobians of the points the
save sequence marks come from batched `plant.jacobians` calls (`in_chunks`:
chunks whose dense (2n)^2 matrices stay under JACOBIAN_CHUNK_BYTES), where
the JAX package makes one host call a point.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.sim.fem_surrogate import FEMSurrogate, simulate
from soft_robot_control_tpu_torch.utils.io import save_data

# device memory of one chunk of dense Jacobians (A of every point in it)
JACOBIAN_CHUNK_BYTES = 1 << 30


class Point:
    """One captured simulation step (utils.py:19-39's fields; the FEM
    matrices K/D/M/H/S/b/f are replaced by the analytic (A, B, d))."""

    def __init__(self):
        self.step = None
        self.t = None
        self.q = None
        self.v = None
        self.u = None
        self.q_next = None
        self.v_next = None
        self.dt = None
        self.A = None
        self.B = None
        self.d = None


class SnapshotData:
    """Generic snapshot collector (utils.py:42-118 contract)."""

    def __init__(self, save_dynamics: bool = True):
        self.save_dynamics = save_dynamics
        self.dict = {"t": [], "q": [], "v": [], "u": [], "q+": [], "v+": [],
                     "dt": -1}
        if save_dynamics:
            self.dict.update({"A": [], "B": [], "d": []})

    def save_snapshot(self, point: Point, prev_point: Optional[Point]) -> bool:
        """Override to implement selective capture; default saves all."""
        return True

    def add_point(self, point: Point):
        if self.dict["dt"] == -1:
            self.dict["dt"] = point.dt
        self.dict["t"].append(point.t)
        self.dict["q"].append(point.q)
        self.dict["v"].append(point.v)
        self.dict["u"].append(point.u)
        self.dict["q+"].append(point.q_next)
        self.dict["v+"].append(point.v_next)
        if self.save_dynamics:
            self.dict["A"].append(point.A)
            self.dict["B"].append(point.B)
            self.dict["d"].append(point.d)

    def simulation_end(self, filename: Optional[str]):
        if self.dict["q"]:
            if filename is not None:
                save_data(filename, self.dict)
        else:
            print("No snapshots to save.")
        return self.dict


def in_chunks(fn, X, U):
    """fn(X[s:e], U[s:e]) over the points X (k, 2n), U (k, m) in chunks of
    as many points as keep a dense (2n)^2 matrix each under
    JACOBIAN_CHUNK_BYTES; its tensors concatenated as numpy arrays with a
    leading axis of k."""
    per = max(1, JACOBIAN_CHUNK_BYTES // (X.shape[-1] ** 2
                                          * X.element_size()))
    parts = [[a.cpu().numpy() for a in fn(X[s:s + per], U[s:s + per])]
             for s in range(0, X.shape[0], per)]
    return tuple(np.concatenate(p) for p in zip(*parts))


def run_open_loop_collection(plant: FEMSurrogate, u_sequence, save_sequence,
                             dt: float, snapshots: SnapshotData,
                             x0=None, filename: Optional[str] = None):
    """Drive the plant under (u_sequence (m, T) or (T, m), save_sequence)
    and feed the collector, the OpenLoopController capture loop
    (open_loop_controller.py:71-205): the whole trajectory simulated on the
    plant's device, the capture decisions made on the host afterwards."""
    u = np.asarray(u_sequence, float)
    if u.shape[0] == plant.input_dim and u.ndim == 2 and u.shape[0] != u.shape[1]:
        u = u.T
    T = u.shape[0]
    save_seq = np.asarray(save_sequence, bool)
    x0 = plant.x_rest() if x0 is None else x0
    X = simulate(plant, x0, u, dt).cpu().numpy()
    n = plant.n_nodes_dof
    steps = [i for i in range(T) if save_seq[min(i, len(save_seq) - 1)]]
    if snapshots.save_dynamics and steps:
        A, B, d = in_chunks(plant.jacobians, *(torch.as_tensor(
            a[steps], dtype=plant.dtype, device=plant.device)
            for a in (X, u)))

    prev_point = None
    for k, i in enumerate(steps):
        pt = Point()
        pt.step = i
        pt.t = i * dt
        pt.q = X[i, n:]
        pt.v = X[i, :n]
        pt.u = u[i]
        pt.q_next = X[i + 1, n:]
        pt.v_next = X[i + 1, :n]
        pt.dt = dt
        if snapshots.save_dynamics:
            pt.A, pt.B, pt.d = A[k], B[k], d[k]
        if snapshots.save_snapshot(pt, prev_point):
            snapshots.add_point(pt)
        prev_point = pt
    return snapshots.simulation_end(filename)
