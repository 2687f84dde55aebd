"""Polyhedral constraint sets {x : A x <= b}.

Held as float64 numpy arrays: the LOCP specs read them once when they build
their static row layout and cast them to the compute dtype and device there.
Membership, violation and the Euclidean projection take tensors and run on
their device, in their dtype; the projection solves its QP with the port's
dense ADMM (`qp/admm.py:solve_qp_dense`).
"""

from __future__ import annotations

import numpy as np
import torch


class Polyhedron:
    """{x : A x <= b}. A: (n_c, n), b: (n_c,)."""

    def __init__(self, A, b):
        self.A = np.asarray(A, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)

    @property
    def dim(self):
        return self.A.shape[1]

    def _resid(self, x):
        """A x - b over the leading batch axes of the tensor x (..., n)."""
        x = torch.as_tensor(x)
        A = torch.as_tensor(self.A, dtype=x.dtype, device=x.device)
        b = torch.as_tensor(self.b, dtype=x.dtype, device=x.device)
        return torch.einsum("ij,...j->...i", A, x) - b

    def contains(self, x):
        """True where x lies in the polyhedron (over leading batch axes)."""
        return self._resid(x).amax(dim=-1) <= 0

    def violation(self, x):
        """2-norm of the positive part of the constraint residual (0 where
        x is feasible), over leading batch axes."""
        return torch.linalg.vector_norm(torch.clamp(self._resid(x), min=0.0),
                                        dim=-1)

    def project(self, x, iters: int = 4000):
        """Euclidean projection of one point x (n,) onto the polyhedron:
        min 0.5 ||y - x||^2  s.t.  A y <= b, by the dense ADMM QP solver."""
        from soft_robot_control_tpu_torch.qp.admm import solve_qp_dense

        x = torch.as_tensor(x)
        A = torch.as_tensor(self.A, dtype=x.dtype, device=x.device)
        b = torch.as_tensor(self.b, dtype=x.dtype, device=x.device)
        P = torch.eye(A.shape[1], dtype=x.dtype, device=x.device)
        l = torch.full_like(b, -float("inf"))
        return solve_qp_dense(P, -x, A, l, b, max_iter=iters).x


class HyperRectangle(Polyhedron):
    """Axis-aligned box lb <= x <= ub as a Polyhedron, with the reference's
    interleaved row layout [x_i <= ub_i; -x_i <= -lb_i] per coordinate."""

    def __init__(self, ub, lb):
        ub = np.asarray(ub, dtype=np.float64)
        lb = np.asarray(lb, dtype=np.float64)
        n = len(ub)
        A = np.kron(np.eye(n), np.array([[1.0], [-1.0]]))
        b = np.stack([ub, -lb], axis=1).reshape(-1)
        super().__init__(A, b)
