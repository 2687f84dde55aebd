"""FEM surrogate plant (the SOFA replacement of the JAX package):

    M qdd = -K (q - q_rest) - D qd - gamma (q - q_rest)^3 + H u
    D = alpha M + beta K            (Rayleigh damping, environments.py:23-26)

packed as x = [v; q], with M = m_node I. The cubic hardening term makes
the plant nonlinear. Its analytic Jacobians play the role of SOFA's
exported stiffness matrices (utils.py:180-206). The plant's tensors lie on
one device; `f`, `jacobians` and `step` take any leading batch axes, and
the `simulate*` functions are loops over time on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.core.packing import qv2x, x2qv
from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                       resolve_device)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class FEMSurrogate:
    """Second-order structural plant with cubic hardening.

    K: (n, n) stiffness; m_node: scalar nodal mass; alpha, beta: Rayleigh
    coefficients; gamma: cubic hardening coefficient; q_rest: (n,); H:
    (n, m) input matrix (cable directions). The scalars stay Python
    floats; the arrays become tensors of their own dtype on `device`.
    """

    def __init__(self, K, m_node, alpha, beta, gamma, q_rest, H,
                 device="cuda"):
        dev = resolve_device(device)
        self.K = as_tensor(K, device=dev)
        self.q_rest = as_tensor(q_rest, device=dev)
        self.H = as_tensor(H, device=dev)
        self.m_node = float(m_node)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gamma = float(gamma)

    @property
    def device(self):
        return self.K.device

    @property
    def dtype(self):
        return self.K.dtype

    @property
    def n_nodes_dof(self) -> int:
        return self.K.shape[0]

    @property
    def state_dim(self) -> int:
        return 2 * self.K.shape[0]

    @property
    def input_dim(self) -> int:
        return self.H.shape[1]

    @property
    def D(self):
        """Rayleigh damping D = alpha M + beta K."""
        n = self.n_nodes_dof
        I = torch.eye(n, dtype=self.K.dtype, device=self.K.device)
        return self.alpha * self.m_node * I + self.beta * self.K

    def x_rest(self):
        return qv2x(self.q_rest, torch.zeros_like(self.q_rest))

    def _xu(self, x, u):
        t = lambda a: as_tensor(a, self.K.dtype, self.K.device)
        return t(x), t(u)

    # dynamics -----------------------------------------------------------
    def f(self, x, u):
        """Continuous dynamics xdot = f(x, u), x = [v; q]."""
        x, u = self._xu(x, u)
        q, v = x2qv(x)
        dq = q - self.q_rest
        force = (-_mv(self.K, dq) - _mv(self.D, v) - self.gamma * dq**3
                 + _mv(self.H, u))
        vdot = force / self.m_node
        # xdot = [vdot; qdot] with qdot = v, in the same [v; q] packing
        return qv2x(v, vdot)

    def jacobians(self, x, u):
        """Analytic (A, B, d) of the affine expansion at (x, u):
        A = [[-M^-1 D, -M^-1 K_t], [I, 0]] with the tangent stiffness
        K_t = K + 3 gamma diag((q - q_rest)^2) (extract_AB,
        utils.py:251-286)."""
        x, u = self._xu(x, u)
        q, _ = x2qv(x)
        n = self.n_nodes_dof
        lead = x.shape[:-1]
        dq = q - self.q_rest
        Kt = self.K + torch.diag_embed(3.0 * self.gamma * dq**2)
        Minv = 1.0 / self.m_node
        A = torch.zeros(lead + (2 * n, 2 * n), dtype=x.dtype, device=x.device)
        A[..., :n, :n] = -Minv * self.D
        A[..., :n, n:] = -Minv * Kt
        A[..., n:, :n] = torch.eye(n, dtype=x.dtype, device=x.device)
        B = torch.cat((Minv * self.H, torch.zeros_like(self.H)), dim=0)
        B = B.expand(lead + B.shape)
        d = self.f(x, u) - _mv(A, x) - _mv(B, u)
        return A, B, d

    # time stepping --------------------------------------------------------
    def step(self, x, u, dt):
        """Linearly implicit Euler step, the integrator family of SOFA's
        EulerImplicitSolver: (I - dt A(x)) dx = dt f(x, u); x+ = x + dx,
        one dense solve."""
        x, u = self._xu(x, u)
        A, _, _ = self.jacobians(x, u)
        I = torch.eye(self.state_dim, dtype=x.dtype, device=x.device)
        dx = torch.linalg.solve(I - dt * A, dt * self.f(x, u))
        return x + dx


def simulate(plant: FEMSurrogate, x0, u_seq, dt):
    """Roll the plant under an input sequence u_seq (N, m). Returns the
    trajectory (N+1, 2n)."""
    x = as_tensor(x0, plant.dtype, plant.device)
    u = as_tensor(u_seq, plant.dtype, plant.device)
    xs = [x]
    for k in range(u.shape[0]):
        x = plant.step(x, u[k], dt)
        xs.append(x)
    return torch.stack(xs)


def simulate_batch(plant: FEMSurrogate, x0, u_seq, dt):
    """Batched initial conditions (B, 2n) and inputs (B, N, m) ->
    (B, N+1, 2n); every step is one batched step of all B plants."""
    u = as_tensor(u_seq, plant.dtype, plant.device)
    return simulate(plant, x0, u.transpose(0, 1), dt).transpose(0, 1)


def simulate_batch_chunked(plant, x0, u_seq, dt, chunk: int = 50):
    """`simulate_batch` in time chunks of `chunk` steps, the JAX package's
    call. Each chunk starts from the last state of the one before, so the
    result equals `simulate_batch`'s. Returns (B, T+1, 2n)."""
    u = as_tensor(u_seq, plant.dtype, plant.device)
    x = as_tensor(x0, plant.dtype, plant.device)
    outs = [x[:, None]]
    for s in range(0, u.shape[1], chunk):
        X = simulate_batch(plant, x, u[:, s:s + chunk], dt)[:, 1:]
        outs.append(X)
        x = X[:, -1]
    return torch.cat(outs, dim=1)


def simulate_chunked(plant, x0, u_seq, dt, chunk: int = 500):
    """`simulate` in time chunks of `chunk` steps, the JAX package's call;
    the result equals `simulate`'s. Returns (T+1, 2n)."""
    u = as_tensor(u_seq, plant.dtype, plant.device)
    x = as_tensor(x0, plant.dtype, plant.device)
    outs = [x[None]]
    for s in range(0, u.shape[0], chunk):
        X = simulate(plant, x, u[s:s + chunk], dt)[1:]
        outs.append(X)
        x = X[-1]
    return torch.cat(outs, dim=0)


# ---------------------------------------------------------------------------
# Factory: a small diamond/trunk-like robot


def make_chain_robot(n_nodes: int = 12, n_cables: int = 4, k: float = 40.0,
                     m_node: float = 0.05, alpha: float = 1.5,
                     beta: float = 0.01, gamma: float = 25.0,
                     seed: int = 0, dtype=np.float64,
                     device="cuda") -> FEMSurrogate:
    """A fixed-base chain of nodes with nearest-neighbor springs and
    `n_cables` cables pulling on distributed node sets, structurally
    analogous to the Diamond (4 cables) / Trunk (8 cables) robots. The
    arrays are built in numpy from default_rng(seed), as the JAX package
    builds them."""
    rng = np.random.default_rng(seed)
    n = n_nodes
    # chain stiffness (tridiagonal SPD), fixed base via a strong anchor on
    # node 0
    K = np.zeros((n, n))
    for i in range(n - 1):
        K[i, i] += k
        K[i + 1, i + 1] += k
        K[i, i + 1] -= k
        K[i + 1, i] -= k
    K[0, 0] += 10 * k  # anchor
    # cables: each pulls a random contiguous span of nodes with a decaying
    # profile
    H = np.zeros((n, n_cables))
    for c in range(n_cables):
        start = rng.integers(0, n // 2)
        profile = np.exp(-0.3 * np.arange(n - start))
        sign = 1.0 if c % 2 == 0 else -1.0
        H[start:, c] = sign * profile
    q_rest = rng.normal(0.0, 0.2, size=n)
    return FEMSurrogate(K.astype(dtype), dtype(m_node), dtype(alpha),
                        dtype(beta), dtype(gamma), q_rest.astype(dtype),
                        H.astype(dtype), device=device)
