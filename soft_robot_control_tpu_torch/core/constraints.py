"""Polyhedral constraint sets {x : A x <= b}.

Held as float64 numpy arrays: the LOCP specs read them once when they build
their static row layout and cast them to the compute dtype and device there.
The QP reprojection (`project`) is not ported yet.
"""

from __future__ import annotations

import numpy as np


class Polyhedron:
    """{x : A x <= b}. A: (n_c, n), b: (n_c,)."""

    def __init__(self, A, b):
        self.A = np.asarray(A, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)

    @property
    def dim(self):
        return self.A.shape[1]


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
