"""Measurement / output models: node-selection matrices y = C x
(sofacontrol/measurement_models.py) over the packed full state
x = [v(3n); q(3n)] (3 DoF per node), with optional additive Gaussian
noise. C is kept as the selected column indices, so y = C x is a gather;
`C_dense` materializes it as float64 numpy for ROM projection. Noise is
drawn from an explicit `torch.Generator` (where the JAX package takes a
PRNG key), on the generator's device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.core.packing import x2qv


def _selection_rows(nodes, num_nodes, pos: bool, vel: bool):
    """Column indices of the selected components, ordered [v-block;
    q-block] (measurement_models.py:29-37)."""
    nodes = list(nodes)
    cols = []
    if vel:
        for node in nodes:
            cols += [3 * node, 3 * node + 1, 3 * node + 2]
    if pos:
        for node in nodes:
            cols += [3 * num_nodes + 3 * node, 3 * num_nodes + 3 * node + 1,
                     3 * num_nodes + 3 * node + 2]
    return np.asarray(cols, dtype=np.int64)


def _qv_order(z):
    """[v; q] -> [q; v] on the last axis."""
    q, v = x2qv(z)
    return torch.cat((q, v), dim=-1)


class linearModel:
    """y = C x on a node subset (measurement_models.py:7-44); x a tensor
    or an array (..., 6 num_nodes), y a tensor on x's device."""

    def __init__(self, nodes, num_nodes, pos=True, vel=True):
        self.pos, self.vel = pos, vel
        self.num_nodes = num_nodes
        self.cols = _selection_rows(nodes, num_nodes, pos, vel)
        self.n_full = 6 * num_nodes

    @property
    def C(self):
        return self.C_dense()

    def C_dense(self):
        C = np.zeros((len(self.cols), self.n_full))
        C[np.arange(len(self.cols)), self.cols] = 1.0
        return C

    def _select(self, x):
        x = torch.as_tensor(x)
        return x[..., torch.as_tensor(self.cols, device=x.device)]

    def evaluate(self, x, qv=False):
        z = self._select(x)
        return _qv_order(z) if qv else z


def _normal(n, generator, dtype):
    """n standard normal draws from the generator, on its device."""
    return torch.randn(n, generator=generator, dtype=dtype,
                       device=generator.device)


class MeasurementModel(linearModel):
    """Noisy measurement y = C x + w, w = mean + chol(cov) N(0, I) with
    cov = blockdiag(S_v, S_q) (measurement_models.py:47-84)."""

    def __init__(self, nodes, num_nodes, pos=True, vel=True, mu_q=None,
                 S_q=None, mu_v=None, S_v=None, qv=False):
        super().__init__(nodes, num_nodes, pos=pos, vel=vel)
        ny = len(self.cols)
        pos_dim = 3 * len(nodes) if pos else 0
        vel_dim = 3 * len(nodes) if vel else 0
        mu_q = np.zeros(pos_dim) if mu_q is None else np.asarray(mu_q)
        mu_v = np.zeros(vel_dim) if mu_v is None else np.asarray(mu_v)
        S_q = np.zeros((pos_dim, pos_dim)) if S_q is None else np.asarray(S_q)
        S_v = np.zeros((vel_dim, vel_dim)) if S_v is None else np.asarray(S_v)
        self.mean = np.concatenate((mu_v, mu_q)).astype(np.float64)
        cov = np.zeros((ny, ny))
        cov[:vel_dim, :vel_dim] = S_v
        cov[vel_dim:, vel_dim:] = S_q
        self.covariance = cov
        # Cholesky factor for sampling (the tiny ridge guards a zero
        # covariance)
        self._chol = np.linalg.cholesky(cov + 1e-300 * np.eye(ny))
        self.qv = qv

    def evaluate(self, x, generator: Optional[torch.Generator] = None):
        z = self._select(x)
        if generator is not None:
            w = _normal(len(self.cols), generator, z.dtype)
            t = lambda a: torch.as_tensor(a, dtype=w.dtype, device=w.device)
            z = z + (t(self.mean) + t(self._chol) @ w).to(z.device)
        return _qv_order(z) if self.qv else z
