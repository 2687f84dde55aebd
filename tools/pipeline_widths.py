"""The offline Diamond pipeline at chip_smoke.py phase 22(b)'s settings over
several widths of the chain: how the TPWL rollout's error against the plant
(`rel_err`, the z error over the motion's) depends on the mesh's width.

    python tools/pipeline_widths.py [--device cpu] [--dt DT]... WIDTH...

At each width: DiamondRobot(n_nodes=WIDTH) with its dt (0.01), or with
each DT given, the recipes' defaults (40 LHS samples, t_step 0.3), the
POD basis at r = chip_smoke.PIPE_WIDE_R, the dictionary at collect_tpwl_data's defaults and
the rollout check at 10 samples, in f64, into build/pipeline_widths/.
Prints one JSON line: per width the dictionary's size, rel_err, the MSE,
the output's motion (its RMS about its mean, rel_err's denominator) and
each stage's wall time (s), with the card's name and power limit on a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import PIPE_WIDE_R  # noqa: E402
from soft_robot_control_tpu_torch.robots import DiamondRobot  # noqa: E402
from soft_robot_control_tpu_torch.tasks import recipes  # noqa: E402


def run(width, device, dt=None):
    robot = DiamondRobot(n_nodes=width, device=device)
    if dt is not None:
        robot.dt = robot.sequences.dt = dt
    d = os.path.join(ROOT, "build", "pipeline_widths",
                     f"{device}{width}_{robot.dt}")
    stages = {
        "pod_data": lambda: recipes.collect_pod_data(robot, d),
        "pod_basis": lambda: recipes.compute_pod_basis(d,
                                                       rom_dim=PIPE_WIDE_R),
        "tpwl_data": lambda: recipes.collect_tpwl_data(robot, d),
        "rollout_check": lambda: recipes.tpwl_rollout_check(
            robot, d, nbr_samples=10)}
    out, secs = {}, {}
    for name, fn in stages.items():
        t0 = time.perf_counter()
        out[name] = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    chk = out["rollout_check"]
    z = chk["z_true"]
    return dict(dt=robot.dt, points=out["tpwl_data"].num_points,
                rel_err=chk["rel_err"], mse=chk["mse"],
                motion_rms=float(np.sqrt(np.mean(np.sum(
                    (z - z.mean(0)) ** 2, axis=1)))), stages_s=secs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dt", type=float, action="append")
    ap.add_argument("widths", type=int, nargs="+")
    a = ap.parse_args()
    res = {"device": a.device}
    if a.device == "cuda":
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    for w in a.widths:
        for dt in a.dt or [None]:
            key = w if dt is None else f"{w} dt={dt}"
            res[key] = run(w, a.device, dt)
            print(key, res[key], file=sys.stderr, flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
