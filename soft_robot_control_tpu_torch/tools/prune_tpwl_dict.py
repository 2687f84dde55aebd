"""Prune a TPWL dictionary to a target size with a greedy distance pass: the
twin of tools/prune_tpwl_dict.py on the port.

A collection with figure-8 segments mixed into the LHS data (the
reference's trunk.py:186-192) gives a dense dictionary (P ~ 4900 at
threshold 15): points along slowly swept orbits lie far closer together
than the build threshold requires. A greedy thinning in visit order (keep
a point iff its weighted distance to every kept point exceeds tau) keeps
the orbits covered while it shrinks P, the artifact, the nearest-point
search of every step and the DARE gains' set-up.

The distance is the model's nearest-point metric (models/tpwl.py
dist_weights {q: 10, v: 1}, squared Euclidean in reduced coordinates), so
the pruned model selects as the full one wherever kept points are dense.

    python -m soft_robot_control_tpu_torch.tools.prune_tpwl_dict \
        --dict runs/trunk_tet/tpwl_model_snapshots.pkl --target 1200 \
        [--check] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np


def greedy_keep(q, v, tau, wq=10.0, wv=1.0):
    """Indices kept by one greedy pass in storage (visit) order.

    The local threshold is graded by the distance from the rest point
    (point 0): tau_i = tau * (0.05 + d(x_i, x_rest) / d_max), so that the
    small orbits near rest, the closed-loop task's regime, keep a finer
    resolution; a uniform tau removes them first (their points lie
    closest together)."""
    P = q.shape[0]
    d_rest = wq * np.sum((q - q[0]) ** 2, axis=1) + \
        wv * np.sum((v - v[0]) ** 2, axis=1)
    grade = 0.05 + d_rest / max(d_rest.max(), 1e-12)
    kept = [0]
    kq = [q[0]]
    kv = [v[0]]
    for i in range(1, P):
        d = wq * np.sum((np.asarray(kq) - q[i]) ** 2, axis=1) + \
            wv * np.sum((np.asarray(kv) - v[i]) ** 2, axis=1)
        if d.min() > tau * grade[i]:
            kept.append(i)
            kq.append(q[i])
            kv.append(v[i])
    return np.asarray(kept)


def prune(data, target, wq=10.0, wv=1.0):
    """The dictionary `data` pruned to within 5% of `target` points by
    bisection on tau: (pruned dictionary, kept indices, tau). Its info
    records nbr_lin, pruned_from and prune_tau."""
    q = np.asarray(data["q"], np.float64)
    v = np.asarray(data["v"], np.float64)
    lo, hi = 0.0, float(wq * np.sum((q.max(0) - q.min(0)) ** 2)
                        + wv * np.sum((v.max(0) - v.min(0)) ** 2))
    kept = np.arange(q.shape[0])
    for _ in range(40):
        tau = 0.5 * (lo + hi)
        kept = greedy_keep(q, v, tau, wq, wv)
        n = len(kept)
        if abs(n - target) <= max(1, int(0.05 * target)):
            break
        if n > target:
            lo = tau
        else:
            hi = tau
    out = dict(data)
    for k in ("q", "v", "u", "A_c", "B_c", "d_c", "A_d", "B_d", "d_d"):
        if k in data and data[k] is not None:
            out[k] = np.asarray(data[k])[kept]
    out["info"] = dict(data.get("info", {}))
    out["info"]["nbr_lin"] = str(len(kept))
    out["info"]["pruned_from"] = int(q.shape[0])
    out["info"]["prune_tau"] = float(tau)
    return out, kept, tau


def check(data, out, robot_name, device, log=print):
    """The pruned model against the full one (no plant): both rolled out
    under the robot's figure-8 inputs at three held-out amplitudes and
    periods in float32 (the JAX tool runs without x64); the worst
    relative deviation of the output."""
    import torch

    from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
    from soft_robot_control_tpu_torch.robots.robots import (DiamondTetRobot,
                                                            TrunkTetRobot)
    from soft_robot_control_tpu_torch.utils.device import to_numpy

    cls = TrunkTetRobot if robot_name == "trunk" else DiamondTetRobot
    robot = cls(dtype=torch.float32, device=device)
    Hf = robot.get_output_model()
    params = {"dist_weights": {"q": 10.0, "v": 1.0}}
    m_full, m_prun = (from_tpwl_dict(
        dict(d), params=params, Hf=Hf, discr_method="be",
        device=device).to(dtype=torch.float32).pre_discretize(robot.dt)
        for d in (data, out))
    worst = 0.0
    for amp, period in ((75.0, 1.25), (125.0, 1.75), (175.0, 2.25)):
        u_seq, _, _ = robot.sequences.traj_tracking(amplitude=amp,
                                                    period=period)
        u = torch.as_tensor(np.asarray(u_seq).T, dtype=torch.float32,
                            device=device)
        x0 = m_full.rom.project_x(m_full.rom.x_ref)
        zf = to_numpy(m_full.rollout(x0, u, robot.dt)[1])
        zp = to_numpy(m_prun.rollout(x0, u, robot.dt)[1])
        rel = (np.linalg.norm(zp - zf)
               / max(np.linalg.norm(zf - zf.mean(0)), 1e-9))
        log(f"  fig-8 amp {amp:5.0f} period {period}: pruned-vs-full "
            f"rel {rel:.4f}")
        worst = max(worst, rel)
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dict", required=True)
    ap.add_argument("--target", type=int, default=1200)
    ap.add_argument("--out", default=None,
                    help="default: overwrite --dict (old file kept as .full)")
    ap.add_argument("--check", action="store_true",
                    help="model-vs-model rollout check on held-out figure-8 "
                    "inputs (pruned vs full TPWL, no plant sim)")
    ap.add_argument("--robot", default="trunk", choices=["trunk", "diamond"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the --check rollouts run")
    args = ap.parse_args(argv)

    with open(args.dict, "rb") as f:
        data = pickle.load(f)
    P0 = np.asarray(data["q"]).shape[0]
    out, kept, tau = prune(data, args.target)
    print(f"pruned P {P0} -> {len(kept)} (tau {tau:.4g})", flush=True)

    if args.check:
        from soft_robot_control_tpu_torch.utils.device import resolve_device

        worst = check(data, out, args.robot, resolve_device(args.device),
                      log=lambda s: print(s, flush=True))
        if worst > 0.10:
            print(f"CHECK FAILED: pruned model deviates {worst:.3f} > 0.10 "
                  "from the full model; raise --target", flush=True)
            sys.exit(1)

    dst = args.out or args.dict
    if dst == args.dict:
        os.replace(args.dict, args.dict + ".full")
        print(f"original kept at {args.dict}.full", flush=True)
    tmp = dst + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, dst)
    print(f"wrote {dst} (P={len(kept)})", flush=True)
    return out, kept, tau


if __name__ == "__main__":
    main()
