"""Post-hoc analysis: tracking MSE and solve-time statistics
(examples/diamond/plotting.py:118-145, examples/trunk/plotting.py:
119-148): the target interpolated onto the simulation grid, the mean
squared tracking error over selected output dimensions, min/mean/max of
the recorded solve times. The port's own numpy copy of the JAX package's
tasks/analysis.py."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def tracking_mse(sim_data: dict, t_target, z_target,
                 dims: Optional[Sequence[int]] = None,
                 t_start: float = 0.0) -> dict:
    """MSE of sim_data['z'] against the interpolated target."""
    t = np.asarray(sim_data["t"])
    z = np.asarray(sim_data["z"])
    z_target = np.atleast_2d(np.asarray(z_target, float))
    if z_target.shape[0] == 1:
        z_des = np.tile(z_target, (len(t), 1))
    else:
        z_des = np.stack([np.interp(t, np.asarray(t_target), z_target[:, j])
                          for j in range(z_target.shape[1])], axis=1)
    dims = list(dims) if dims is not None else list(range(z.shape[1]))
    mask = t >= t_start
    err = z[mask][:, dims] - z_des[mask][:, dims]
    return {
        "mse": float(np.mean(np.sum(err**2, axis=1))),
        "rmse_per_dim": np.sqrt(np.mean(err**2, axis=0)),
        "max_err": float(np.max(np.abs(err))),
    }


def solve_time_stats(sim_data: dict) -> Optional[dict]:
    """min/mean/max of recorded solve times (plotting.py:118-124)."""
    info = sim_data.get("info", {})
    times = info.get("solve_times")
    if not times:
        return None
    times = np.asarray([t for t in times if t is not None], float)
    return {"min": float(times.min()), "mean": float(times.mean()),
            "max": float(times.max()), "count": len(times)}


def summarize(sim_data: dict, t_target, z_target, dims=None,
              t_start: float = 0.0, label: str = "") -> dict:
    out = {"label": label,
           "tracking": tracking_mse(sim_data, t_target, z_target, dims=dims,
                                    t_start=t_start),
           "solve_times": solve_time_stats(sim_data)}
    return out
