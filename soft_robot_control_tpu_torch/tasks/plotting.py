"""Plotting / analysis figures (headless, saved to file).

Capability parity with the reference analysis scripts
(examples/*/plotting.py, plotting_OL.py, plotInputs.py): closed-loop
tracking overlays, input trajectories, solve-time statistics, and 3D
trajectory comparisons, from numpy sim dicts. matplotlib is imported when
a figure is drawn, with the Agg backend, so the module loads without it
and runs headless.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_tracking(sim_data: dict, t_target, z_target, dims=None,
                  save_path: Optional[str] = None, label: str = "sim"):
    """Overlay sim z against the target (plotting.py:60-116 role)."""
    plt = _plt()
    t = np.asarray(sim_data["t"])
    z = np.asarray(sim_data["z"])
    z_target = np.atleast_2d(np.asarray(z_target, float))
    dims = list(dims) if dims is not None else list(range(z.shape[1]))
    fig, axes = plt.subplots(len(dims), 1, figsize=(8, 2.5 * len(dims)),
                             squeeze=False)
    for ax, d in zip(axes[:, 0], dims):
        ax.plot(t, z[:, d], label=label)
        zt = np.interp(t, np.asarray(t_target), z_target[:, d]) \
            if z_target.shape[0] > 1 else np.full_like(t, z_target[0, d])
        ax.plot(t, zt, "--", label="target")
        ax.set_ylabel(f"z[{d}]")
        ax.legend()
    axes[-1, 0].set_xlabel("t [s]")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_inputs(sim_data: dict, save_path: Optional[str] = None):
    """Input trajectories (plotInputs.py role)."""
    plt = _plt()
    t = np.asarray(sim_data["t"])
    u = np.asarray(sim_data["u"])
    fig, ax = plt.subplots(figsize=(8, 3))
    for j in range(u.shape[1]):
        ax.plot(t, u[:, j], label=f"u[{j}]")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("u")
    ax.legend(ncol=4)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_solve_times(sim_data: dict, realtime_limit: Optional[float] = None,
                     save_path: Optional[str] = None):
    """Per-solve times with the real-time budget line
    (examples/diamond/plotting.py:108-124 role)."""
    plt = _plt()
    times = np.asarray([t for t in sim_data.get("info", {}).get("solve_times", [])
                        if t is not None], float)
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.plot(times * 1e3, ".-")
    if realtime_limit is not None:
        ax.axhline(realtime_limit * 1e3, color="r", ls="--",
                   label="real-time limit")
        ax.legend()
    ax.set_xlabel("solve #")
    ax.set_ylabel("solve time [ms]")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_trajectory_3d(z_list: Sequence, labels: Sequence[str],
                       save_path: Optional[str] = None):
    """3D overlay of output trajectories (module-test style,
    examples/hardware/diamond_SSM.py:66-72)."""
    plt = _plt()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    for z, lab in zip(z_list, labels):
        z = np.asarray(z)
        if z.shape[1] < 3:
            z = np.column_stack([z] + [np.zeros(len(z))] * (3 - z.shape[1]))
        ax.plot3D(z[:, 0], z[:, 1], z[:, 2], label=lab)
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
