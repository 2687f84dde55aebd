"""Baseline-comparison analysis and plotting across controllers.

Capability parity with the reference's hardware plotting suite
(examples/hardware/plotting.py, 412 lines; examples/diamond/plotting.py:
118-145): overlay several controllers' closed-loop runs (TPWL / SSM /
Koopman / ROMPC / ...) against one target — x-y (or 3D) trajectory overlay
with optional constraint box, per-axis time series, solve-time statistics
against the real-time limit, and the reference's MSE methodology
(interpolate each run onto the target clock, mean of squared Euclidean
errors — plotting.py:278-390).

Everything takes the sim pkl layout ({t, z, u, info}) that
sim/closed_loop.py and tasks/recipes.py write in either package (numpy
arrays), which matches the reference's *_sim.pkl. Numpy only; matplotlib
is imported when a figure is drawn. Use as a library or as a CLI:

    python -m soft_robot_control_tpu_torch.tasks.baseline_comparison \\
        --run TPWL=examples/diamond_tet/scp_fig8_sim.pkl \\
        --target-pkl target.pkl --out cmp.png
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from soft_robot_control_tpu_torch.utils.io import load_data


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


STYLES = [
    dict(color="tab:blue", linewidth=3),
    dict(color="tab:green", marker="x", markevery=20, linewidth=1),
    dict(color="tab:orange", marker="^", markevery=20, linewidth=1),
    dict(color="tab:red", marker="d", markevery=20, linewidth=1),
    dict(color="tab:purple", marker="o", markevery=20, linewidth=1),
]


def set_axes_equal(ax):
    """Equal aspect for 3D axes (the reference's utils.set_axes_equal)."""
    limits = np.array([ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()])
    centers = limits.mean(axis=1)
    radius = 0.5 * (limits[:, 1] - limits[:, 0]).max()
    ax.set_xlim3d([centers[0] - radius, centers[0] + radius])
    ax.set_ylim3d([centers[1] - radius, centers[1] + radius])
    ax.set_zlim3d([centers[2] - radius, centers[2] + radius])


def load_run(path_or_data, t_start: float = 0.0):
    """Load a sim pkl, drop the warm-up (t < t_start), rebase time — the
    reference's per-run preprocessing (plotting.py:76-118)."""
    data = path_or_data if isinstance(path_or_data, dict) \
        else load_data(path_or_data)
    t = np.asarray(data["t"], float)
    keep = t >= t_start
    out = {"t": t[keep] - t[keep][0] if keep.any() else t[keep]}
    for k in ("z", "u", "z_hat"):
        if k in data and np.asarray(data[k]).size:
            out[k] = np.asarray(data[k], float)[keep]
    out["info"] = data.get("info", {})
    return out


def tracking_mse(run: dict, t_target, z_target,
                 dims: Optional[Sequence[int]] = None) -> float:
    """The reference's MSE: interpolate the run onto the target clock and
    average the squared Euclidean errors (plotting.py:278-390)."""
    t_target = np.asarray(t_target, float)
    z_target = np.atleast_2d(np.asarray(z_target, float))
    z = np.atleast_2d(run["z"])
    dims = list(range(z_target.shape[1])) if dims is None else list(dims)
    tq = t_target[(t_target >= run["t"][0]) & (t_target <= run["t"][-1])]
    zq = np.stack([np.interp(tq, run["t"], z[:, d]) for d in dims], axis=1)
    zt = np.stack([np.interp(tq, t_target, z_target[:, d]) for d in dims],
                  axis=1)
    return float(np.mean(np.sum((zq - zt) ** 2, axis=1)))


def solve_time_stats(run: dict) -> Optional[dict]:
    st = run.get("info", {}).get("solve_times", None)
    if st is None or not len(st):
        return None
    st = np.asarray(st, float)
    return {"min": float(st.min()), "mean": float(st.mean()),
            "max": float(st.max()), "n": int(len(st))}


def compare_runs(runs: Dict[str, dict], t_target, z_target,
                 dims: Tuple[int, int] = (0, 1),
                 dims3: Optional[Tuple[int, int, int]] = None,
                 constraint_box: Optional[Tuple] = None,
                 realtime_limit: Optional[float] = None,
                 save_prefix: Optional[str] = None):
    """The full baseline-comparison figure set + metric table.

    runs: {label: run dict from load_run}. Produces (when save_prefix):
    <prefix>_xy.png (trajectory overlay), <prefix>_t.png (per-axis time
    series), <prefix>_solvetimes.png; returns {label: {mse, solve_times}}.
    """
    plt = _plt()
    t_target = np.asarray(t_target, float)
    z_target = np.atleast_2d(np.asarray(z_target, float))

    # ---- trajectory overlay (plotting.py:123-203)
    fig1 = plt.figure(figsize=(10, 8), facecolor="w")
    if dims3 is not None:
        ax = fig1.add_subplot(111, projection="3d")
        for (label, run), style in zip(runs.items(), STYLES):
            z = run["z"]
            ax.plot3D(z[:, dims3[0]], z[:, dims3[1]], z[:, dims3[2]],
                      label=label, **style)
        ax.plot3D(z_target[:, dims3[0]], z_target[:, dims3[1]],
                  z_target[:, dims3[2]], "--k", linewidth=1, label="Target")
        ax.set_xlabel(r"$x_{ee}$ [mm]")
        ax.set_ylabel(r"$y_{ee}$ [mm]")
        ax.set_zlabel(r"$z_{ee}$ [mm]")
        set_axes_equal(ax)
    else:
        ax = fig1.add_subplot(111)
        if constraint_box is not None:
            from matplotlib import patches
            (x0, y0, x1, y1) = constraint_box
            ax.add_patch(patches.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                           linewidth=2, color="tab:red",
                                           fill=False))
        for (label, run), style in zip(runs.items(), STYLES):
            z = run["z"]
            ax.plot(z[:, dims[0]], z[:, dims[1]], label=label, **style)
        ax.plot(z_target[:, dims[0]], z_target[:, dims[1]], "--k",
                linewidth=1, label="Target")
        ax.set_xlabel(r"$x_{ee}$ [mm]")
        ax.set_ylabel(r"$y_{ee}$ [mm]")
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    ax.legend()
    if save_prefix:
        fig1.savefig(save_prefix + "_xy.png", dpi=200, bbox_inches="tight")
    plt.close(fig1)

    # ---- per-axis time series (plotting.py:207-276)
    plot_dims = dims3 if dims3 is not None else dims
    fig2, axes = plt.subplots(len(plot_dims), 1,
                              figsize=(14, 4 * len(plot_dims)),
                              facecolor="w", sharex=True)
    axes = np.atleast_1d(axes)
    for j, d in enumerate(plot_dims):
        for (label, run), style in zip(runs.items(), STYLES):
            axes[j].plot(run["t"], run["z"][:, d], label=label, **style)
        axes[j].plot(t_target, z_target[:, d], "--k", linewidth=1,
                     label="Target")
        axes[j].set_ylabel(f"z[{d}] [mm]")
    axes[-1].set_xlabel(r"$t$ [s]")
    axes[0].legend()
    if save_prefix:
        fig2.savefig(save_prefix + "_t.png", dpi=200, bbox_inches="tight")
    plt.close(fig2)

    # ---- solve-time comparison (diamond/plotting.py:103-124)
    st_all = {k: solve_time_stats(r) for k, r in runs.items()}
    if any(v is not None for v in st_all.values()):
        fig3, ax3 = plt.subplots(figsize=(8, 5), facecolor="w")
        labels, data = [], []
        for label, run in runs.items():
            st = run.get("info", {}).get("solve_times", None)
            if st is not None and len(st):
                labels.append(label)
                data.append(np.asarray(st, float) * 1e3)
        ax3.boxplot(data, tick_labels=labels)
        if realtime_limit is not None:
            ax3.axhline(1e3 * realtime_limit, color="r", linestyle="--",
                        label="real-time limit")
            ax3.legend()
        ax3.set_ylabel("solve time [ms]")
        if save_prefix:
            fig3.savefig(save_prefix + "_solvetimes.png", dpi=200,
                         bbox_inches="tight")
        plt.close(fig3)

    # ---- metric table (diamond/plotting.py:118-145 print block)
    table = {}
    for label, run in runs.items():
        table[label] = {"mse": tracking_mse(run, t_target, z_target,
                                            dims=list(plot_dims)),
                        "solve_times": st_all[label]}
    print("------ Mean Squared Errors (MSEs) ----------")
    for label, row in table.items():
        line = f"{label}: MSE {row['mse']:.4g} mm^2"
        if row["solve_times"]:
            s = row["solve_times"]
            line += (f"; solve times min {1e3 * s['min']:.2f} / mean "
                     f"{1e3 * s['mean']:.2f} / max {1e3 * s['max']:.2f} ms")
        print(line)
    return table


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run", action="append", required=True,
                    help="LABEL=path/to/sim.pkl (repeatable)")
    ap.add_argument("--target-pkl",
                    help="pkl with {'t': (T,), 'z': (T, nz)} target")
    ap.add_argument("--t-start", type=float, default=1.0)
    ap.add_argument("--dims", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--realtime-limit", type=float, default=None)
    ap.add_argument("--out", default="baseline_cmp")
    args = ap.parse_args(argv)

    runs = {}
    for spec in args.run:
        label, path = spec.split("=", 1)
        runs[label] = load_run(path, t_start=args.t_start)
    if args.target_pkl:
        tgt = load_data(args.target_pkl)
        t_target, z_target = np.asarray(tgt["t"]), np.asarray(tgt["z"])
    else:  # fall back to the first run's own trajectory clock
        first = next(iter(runs.values()))
        t_target, z_target = first["t"], first["z"]
    dims = tuple(args.dims)
    compare_runs(runs, t_target, z_target,
                 dims=dims[:2], dims3=dims if len(dims) == 3 else None,
                 realtime_limit=args.realtime_limit, save_prefix=args.out)


if __name__ == "__main__":
    main()
