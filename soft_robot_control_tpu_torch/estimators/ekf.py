"""Discrete-time EKF on a reduced-order model with linear measurement
y = C x (sofacontrol/tpwl/observer.py:33-126): predict with the model's
local discrete (A, B, d), covariance A Sigma A' + W; update with the
constant C and gain K = Sigma C' (C Sigma C' + V)^-1.

The step functions take one filter, x (n_x,) and Sigma (n_x, n_x), or a
batch of them over leading axes, x (B, n_x) and Sigma (B, n_x, n_x), as
BatchMPC runs them. The prediction's Jacobians come from one
`get_jacobians` call for all the filters: on a TPWL model, one launch of
the select kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from soft_robot_control_tpu_torch.utils.device import as_tensor
from soft_robot_control_tpu_torch.utils.timing import span


class EKFState(NamedTuple):
    x: torch.Tensor      # (..., n_x) state estimates
    Sigma: torch.Tensor  # (..., n_x, n_x) covariances


def ekf_predict(model, state: EKFState, u, dt, W) -> EKFState:
    """Prediction step (observer.py:97-106) with inputs u (..., n_u)."""
    A, B, d = model.get_jacobians(state.x, dt=dt)
    x = state.x.to(A.dtype)
    u = torch.as_tensor(u, dtype=A.dtype, device=A.device)
    x_pred = (A @ x[..., None] + B @ u[..., None])[..., 0] + d
    Sigma_pred = A @ state.Sigma @ A.transpose(-1, -2) + W
    return EKFState(x_pred, Sigma_pred)


def ekf_correct(model, state: EKFState, y, V, info=None) -> EKFState:
    """Measurement update. `y` (..., n_y) is the full-order measurement; it
    is shifted to reduced coordinates by the model's y_ref.

    info: None, and the gain solves with an LU factorization of the
    innovation covariance S = C Sigma C' + V, which raises
    torch.linalg.LinAlgError at once (a host read of its status) where S is
    singular. Or a bool tensor of one element on the state's device: the
    gain then solves with a Cholesky factor of S, which is symmetric
    positive definite, a failure of any filter of the batch is OR-ed into
    `info` on the device, and nothing is read on the host. The batch-fused
    MPC loop replays that form in a CUDA graph, which can hold the batched
    Cholesky and triangular solves but not a card's batched LU (MAGMA's,
    which stages its pointers in host memory and waits for the card). The
    two forms round differently."""
    with span("ekf.correct"):
        C = model.C
        Sig = state.Sigma
        y_red = y - model.y_ref
        S = C @ Sig @ C.T + V
        # K = Sigma C' S^-1, solved as S' K' = C Sigma'
        rhs = C @ Sig.transpose(-1, -2)
        if info is None:
            Kt = torch.linalg.solve(S.transpose(-1, -2), rhs)
        else:
            L, failed = torch.linalg.cholesky_ex(S.transpose(-1, -2),
                                                 check_errors=False)
            info.logical_or_(failed.ne(0).any())
            Kt = torch.linalg.solve_triangular(
                L.transpose(-1, -2),
                torch.linalg.solve_triangular(L, rhs, upper=False),
                upper=True)
        K = Kt.transpose(-1, -2)
        x_new = state.x + (K @ (y_red - state.x @ C.T)[..., None])[..., 0]
        I = torch.eye(state.x.shape[-1], dtype=state.x.dtype,
                      device=state.x.device)
        Sigma_new = (I - K @ C) @ Sig
        return EKFState(x_new, Sigma_new)


def ekf_update(model, state: EKFState, u, y, dt, W, V) -> EKFState:
    """Full EKF step: predict with input u, correct with measurement y."""
    return ekf_correct(model, ekf_predict(model, state, u, dt, W), y, V)


class DiscreteEKFObserver:
    """Stateful filter with the reference's defaults (observer.py:52-66):
    Sigma0 = I, W = 100 I, V = I; initialized at the ROM reference state.
    Its tensors lie on the model's device in the dtype of the model's
    dictionary; inputs and measurements are cast to it."""

    def __init__(self, dyn_sys, Sigma0=None, W=None, V=None):
        if dyn_sys.C is None:
            raise RuntimeError("Need to set meas. model in dyn_sys")
        self.dyn_sys = dyn_sys
        n = dyn_sys.state_dim
        m = dyn_sys.C.shape[0]
        self.meas_dim = m
        self.state_dim = n
        self._dtype, self._device = dyn_sys.C.dtype, dyn_sys.C.device
        t = lambda a: as_tensor(a, self._dtype, self._device)
        eye = lambda k: torch.eye(k, dtype=self._dtype, device=self._device)
        self.W = eye(n) * 100.0 if W is None else t(W)
        self.V = eye(m) if V is None else t(V)
        Sigma0 = eye(n) if Sigma0 is None else t(Sigma0)
        x0 = dyn_sys.rom.project_x(dyn_sys.rom.x_ref)
        self.state = EKFState(t(x0), Sigma0)

    @property
    def x(self):
        return self.state.x

    @property
    def Sigma(self):
        return self.state.Sigma

    @property
    def z(self):
        if self.dyn_sys.H is not None:
            return self.dyn_sys.x_to_zfyf(self.state.x, zf=True)
        return self.dyn_sys.x_to_zfyf(self.state.x, yf=True)

    def initialize(self, xf):
        x = self.dyn_sys.rom.project_x(as_tensor(xf, device=self._device))
        self.state = EKFState(as_tensor(x, self._dtype, self._device),
                              self.state.Sigma)

    def update(self, u, y, dt, **kwargs):
        t = lambda a: as_tensor(a, self._dtype, self._device)
        self.state = ekf_update(self.dyn_sys, self.state, t(u), t(y),
                                float(dt), self.W, self.V)
        return self.state.x

    def get_meas_dim(self):
        return self.meas_dim

    def get_observer_params(self):
        return {"W": self.W, "V": self.V, "meas_dim": self.meas_dim,
                "state_dim": self.state_dim, "C": self.dyn_sys.C,
                "H": self.dyn_sys.H}
