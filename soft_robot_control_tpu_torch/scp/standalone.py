"""Synchronous, in-process GuSTO trajectory optimization.

Build the initial guess by rolling the model out under zero (or given)
inputs, solve once over the full horizon, and return the plan: the batch
trajectory-optimization entry point.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from soft_robot_control_tpu_torch.scp.gusto import GuSTO
from soft_robot_control_tpu_torch.utils.device import to_numpy


def run_gusto_standalone(model, N, dt, Qz, R, x0, t=None, z=None, u=None,
                         Qzf=None, zf=None, U=None, X=None, Xf=None, dU=None,
                         u_init: Optional[np.ndarray] = None,
                         x_init: Optional[np.ndarray] = None,
                         verbose: int = 0, **kwargs):
    """Solve one open-loop GuSTO problem on the model's device. Returns
    (xopt, uopt, zopt, topt, gusto).

    z may be (N+1, n_z), or a longer trajectory with time stamps t, which
    is then interpolated onto the solver grid; u likewise with N rows.
    """
    topt = dt * np.arange(N + 1)

    if z is not None:
        z = np.asarray(z, float)
        if t is not None and z.shape[0] != N + 1:
            z = np.stack([np.interp(topt, np.asarray(t), z[:, j])
                          for j in range(z.shape[1])], axis=1)
    if u is not None:
        u = np.asarray(u, float)
        if t is not None and u.shape[0] != N:
            tu = topt[:-1]
            u = np.stack([np.interp(tu, np.asarray(t), u[:, j])
                          for j in range(u.shape[1])], axis=1)

    if u_init is None:
        u_init = np.zeros((N, R.shape[0]))
    if x_init is None:
        res = model.rollout(np.asarray(x0, float), u_init, dt)
        # some models return (x, z), others just x
        x_init = to_numpy(res[0] if isinstance(res, tuple) else res)

    gusto = GuSTO(model, N, dt, Qz, R, np.asarray(x0, float), u_init,
                  np.asarray(x_init, float), z=z, u=u, Qzf=Qzf, zf=zf, U=U,
                  X=X, Xf=Xf, dU=dU, verbose=verbose, **kwargs)
    xopt, uopt, zopt, _ = gusto.get_solution()
    return xopt, uopt, zopt, topt, gusto
