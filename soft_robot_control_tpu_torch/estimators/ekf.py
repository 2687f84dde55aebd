"""EKF on a reduced-order model with linear measurement y = C x
(sofacontrol/tpwl/observer.py:108-125), for a batch of filters."""

from __future__ import annotations

from typing import NamedTuple

import torch


class EKFState(NamedTuple):
    x: torch.Tensor      # (B, n_x) state estimates
    Sigma: torch.Tensor  # (B, n_x, n_x) covariances


def ekf_correct(model, state: EKFState, y, V) -> EKFState:
    """Measurement update. `y` (B, n_y) is the full-order measurement; it
    is shifted to reduced coordinates by the model's y_ref."""
    C = model.C
    Sig = state.Sigma
    y_red = y - model.y_ref
    S = C @ Sig @ C.T + V
    # K = Sigma C' S^-1, solved as S' K' = C Sigma'
    K = torch.linalg.solve(S.transpose(-1, -2),
                           C @ Sig.transpose(-1, -2)).transpose(-1, -2)
    x_new = state.x + (K @ (y_red - state.x @ C.T)[..., None])[..., 0]
    I = torch.eye(state.x.shape[-1], dtype=state.x.dtype,
                  device=state.x.device)
    Sigma_new = (I - K @ C) @ Sig
    return EKFState(x_new, Sigma_new)
