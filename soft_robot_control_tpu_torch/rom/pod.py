"""POD reduced basis (sofacontrol/mor/pod.py), online part: affine
projection x_r = U^T (x_f - x_ref) and lift x_f = U x_r + x_ref on the two
halves of the packed state x = [v; q] (the block basis kron(I_2, U) is
never materialized), matrix projection U^T M U, output-matrix projection
H = Hf V; `compute_POD` (the SVD and the energy rule) and `load_POD`.

Every map takes any leading batch axes and computes in the promoted dtype
of its input and of U. The offline pipeline (`get_snapshots`,
`process_snapshots`, `run_POD`) is numpy on the host, as in the JAX
package: the SVD of a few thousand snapshots is no work for the card.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.core.packing import qv2x


class POD:
    """POD basis. U: (n_f, r); q_ref, v_ref: (n_f,), all on one device."""

    def __init__(self, info: dict, device="cuda", dtype=None):
        from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                               resolve_device)

        dev = resolve_device(device)
        as_t = lambda a: as_tensor(a, dtype, dev)
        self.U = as_t(info["U"])
        self.q_ref = as_t(info["q_ref"])
        self.v_ref = as_t(info["v_ref"])

    @property
    def x_ref(self):
        return qv2x(self.q_ref, self.v_ref)

    @property
    def rom_dim(self) -> int:
        return self.U.shape[1]

    @property
    def full_dim(self) -> int:
        return self.U.shape[0]

    def get_info(self) -> dict:
        return {"q_ref": self.q_ref.cpu().numpy(),
                "v_ref": self.v_ref.cpu().numpy(),
                "U": self.U.cpu().numpy(), "type": "POD"}

    def _cast(self, a, *refs):
        """a as a tensor on U's device, and U and refs, all in the
        promoted dtype of a and U."""
        a = torch.as_tensor(a, device=self.U.device)
        dt = torch.promote_types(a.dtype, self.U.dtype)
        return (a.to(dt), self.U.to(dt)) + tuple(r.to(dt) for r in refs)

    # reduced -> full (lift); compute_FO_state (mor/pod.py:22-37)
    def lift_q(self, q):
        q, U, q_ref = self._cast(q, self.q_ref)
        return q @ U.T + q_ref

    def lift_v(self, v):
        v, U, v_ref = self._cast(v, self.v_ref)
        return v @ U.T + v_ref

    def lift_x(self, x):
        r = self.rom_dim
        x, U, q_ref, v_ref = self._cast(x, self.q_ref, self.v_ref)
        v = x[..., :r] @ U.T + v_ref
        q = x[..., r:] @ U.T + q_ref
        return qv2x(q, v)

    # full -> reduced (project); compute_RO_state (mor/pod.py:39-54)
    def project_q(self, qf):
        qf, U, q_ref = self._cast(qf, self.q_ref)
        return (qf - q_ref) @ U

    def project_v(self, vf):
        vf, U, v_ref = self._cast(vf, self.v_ref)
        return (vf - v_ref) @ U

    def project_x(self, xf):
        """Full -> reduced state, (..., 2 n_f) -> (..., 2 r)."""
        n = self.full_dim
        xf, U, q_ref, v_ref = self._cast(xf, self.q_ref, self.v_ref)
        v = (xf[..., :n] - v_ref) @ U
        q = (xf[..., n:] - q_ref) @ U
        return qv2x(q, v)

    # matrix projection; compute_RO_matrix (mor/pod.py:56-72)
    def project_matrix(self, M, left: bool = False, right: bool = False):
        M, U = self._cast(M)
        if (left and right) or (not left and not right):
            return U.T @ M @ U
        if left:
            return U.T @ M
        return M @ U

    def project_block_matrix(self, Mf):
        """Project a full-state matrix Mf ((2n_f, 2n_f), or (n_rows, 2n_f)
        acting on x = [v; q]) with the block basis V = kron(I2, U): V^T Mf
        V, or Mf V, without materializing V."""
        n = self.full_dim
        Mf, U = self._cast(Mf)
        MV = torch.cat((Mf[..., :n] @ U, Mf[..., n:] @ U), dim=-1)
        if Mf.shape[0] == 2 * n:
            return torch.cat((U.T @ MV[:n], U.T @ MV[n:]), dim=0)
        return MV

    def project_output_matrix(self, Hf):
        """H = Hf V for a full-order output matrix Hf (n_z, 2 n_f), in the
        promoted dtype of Hf and U."""
        n = self.full_dim
        Hf, U = self._cast(Hf)
        return torch.cat((Hf[:, :n] @ U, Hf[:, n:] @ U), dim=1)


class pod_config:
    """POD options with the reference defaults (mor/pod.py:81-90)."""

    def __init__(self):
        self.pod_type = "v"  # 'q', 'v' or 'a'
        self.pod_tolerance = 1e-4
        self.preprocess = []
        self.preprocess_args = {"nbr_clusters": 0}


def get_snapshots(data: dict, pod_type: str) -> np.ndarray:
    """The snapshot matrix (n_snap, n_f) of a snapshot dict
    (mor/pod.py:144-154): q - q_0, v, or v+ - v."""
    if pod_type == "q":
        return np.asarray(data["q"]) - np.asarray(data["q"][0])
    if pod_type == "v":
        return np.asarray(data["v"])
    if pod_type == "a":
        return np.asarray(data["v+"]) - np.asarray(data["v"])
    raise ValueError(f"unknown pod_type {pod_type!r}")


def process_snapshots(snapshots: np.ndarray, preprocess, args) -> np.ndarray:
    """Optional preprocessing of the snapshots (n_snap, n_f): 'normalize'
    (per column to [0, 1]), 'substract_mean', 'clustering' (k-means
    centroids, args['nbr_clusters'] > 0)."""
    if "normalize" in preprocess:
        lo, hi = snapshots.min(axis=0), snapshots.max(axis=0)
        snapshots = (snapshots - lo) / (hi + 1e-15 - lo)
    if "substract_mean" in preprocess:
        snapshots = snapshots - snapshots.mean(axis=0, keepdims=True)
    if "clustering" in preprocess and args.get("nbr_clusters", 0) > 0:
        snapshots = compute_kmeans_centroids(snapshots, args["nbr_clusters"])
    return snapshots


def compute_POD(snapshots: np.ndarray, tol: float,
                rom_dim: Optional[int] = None):
    """SVD-based POD of snapshots (n_f, n_snap), in numpy on the host.

    Keeps the smallest r >= 1 whose discarded singular-value energy is
    <= tol, the reference's loop (mor/pod.py:190-200), or r = rom_dim.
    Returns (U_full, U, r, S).
    """
    U_full, S, _ = np.linalg.svd(snapshots, full_matrices=False)
    if rom_dim is not None:
        r = int(rom_dim)
    else:
        s2 = S**2
        tail = np.cumsum(s2[::-1])[::-1] / np.sum(s2)  # sum(s2[i:]) / sum
        ok = np.nonzero(tail <= tol)[0]
        candidates = ok[ok >= 1]
        r = int(candidates[0]) if candidates.size else len(S)
    return U_full, U_full[:, :r], r, S


def run_POD(snapshots_file: str, POD_file: str, config: pod_config,
            rom_dim: Optional[int] = None) -> dict:
    """The offline POD pipeline: load the snapshots pickle, SVD, save the
    POD pickle in the reference layout ({'POD_info', 'config', 'Sigma'},
    mor/pod.py:137-141), and return it."""
    from soft_robot_control_tpu_torch.utils.io import load_data, save_data

    data = load_data(snapshots_file)
    snapshots = get_snapshots(data, config.pod_type)
    snapshots = process_snapshots(snapshots, config.preprocess,
                                  config.preprocess_args)
    _, U, r, S = compute_POD(snapshots.T, config.pod_tolerance,
                             rom_dim=rom_dim)
    POD_info = {"U": U, "q_ref": np.asarray(data["q"][0]),
                "v_ref": np.zeros(np.shape(data["v"][0]))}
    results = {"POD_info": POD_info, "config": vars(config), "Sigma": S}
    save_data(POD_file, results)
    return results


def load_POD(POD_file: str, device="cuda") -> POD:
    """Load a POD basis from a reference-format pickle (mor/pod.py:93-107)
    onto `device`."""
    from soft_robot_control_tpu_torch.utils.io import load_data

    if not os.path.isfile(POD_file):
        raise RuntimeError("POD file specified is not a valid file")
    return POD(load_data(POD_file)["POD_info"], device=device)


def compute_kmeans_centroids(snapshot: np.ndarray, k: int) -> np.ndarray:
    """k-means centroids for POD preprocessing (mor/pod.py:207-216); needs
    scikit-learn, imported here as in the JAX package."""
    from sklearn.cluster import KMeans

    km = KMeans(k, n_init=100, max_iter=1000, random_state=0).fit(snapshot)
    return km.cluster_centers_
