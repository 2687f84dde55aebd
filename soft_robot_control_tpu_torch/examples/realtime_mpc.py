"""Real-time MPC serving: the controller (EKF, linearization, QP assembly,
the ADMM solve, feedback) run as one window a dispatch in a paced loop,
with the deadline margin reported: the twin of examples/realtime_mpc_tpu.py
on the port.

    python -m soft_robot_control_tpu_torch.examples.realtime_mpc \
        [--hz 50] [--seconds 5] [--campaign diamond] \
        [--json runs/realtime_mpc.json] [--device cpu]

With `--campaign diamond` it runs on the committed campaign dictionary at
its dt = 0.01 with the flown N_replan = 2 (one 20 ms window a dispatch),
and its summary must pass tests/test_campaign_artifacts.py's real-time
gates (mean compute under the deadline, p99 under twice it), or the run
fails. The round trip of a trivial operation (a tiny torch op and a
synchronize) is measured beside it and subtracted as the dispatch cost.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from soft_robot_control_tpu_torch.utils.device import resolve_device

CAMPAIGN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "examples", "diamond_tet",
    "tpwl_model_snapshots.pkl")


def controller(campaign=None, hz=50.0, device="cuda", dtype=torch.float32):
    """The script's BatchMPC and its settings: (mpc, dt, n_replan, hz).
    'diamond': the campaign dictionary with its output (node 1354) and
    measurement (5 nodes) maps, condensed, N=4, 50 ADMM iterations, cables
    in [0, 1500] mN, dt and hz set by the dictionary; else the synthetic
    demo model at dt = 1/hz, N=5, N_replan=1, the sparse QP through the
    single-QP kernel."""
    from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC

    if campaign == "diamond":
        from soft_robot_control_tpu_torch.core.constraints import (
            HyperRectangle)
        from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
        from soft_robot_control_tpu_torch.sim.measurement import linearModel

        Hf = linearModel([1354], 1628, vel=False).C_dense()
        Cf = linearModel([1354, 726, 139, 1445, 729], 1628).C_dense()
        model = from_tpwl_dict(CAMPAIGN,
                               params={"dist_weights": {"q": 10.0, "v": 1.0}},
                               Hf=Hf, Cf=Cf, discr_method="be", device=device)
        dt = model.pre_discretized_dt
        n_replan = 2
        hz = 1.0 / (n_replan * dt)
        nz, nu = model.H.shape[0], model.input_dim
        mpc = BatchMPC(model, 100.0 * np.eye(nz), 1e-3 * np.eye(nu), N=4,
                       dt=dt, N_replan=n_replan, qp_iters=50,
                       formulation="condensed", x_step="kinv",
                       use_pallas=True, dtype=dtype,
                       U=HyperRectangle(1500.0 * np.ones(nu), np.zeros(nu)),
                       W=1e-2 * np.eye(model.state_dim),
                       V=1e-4 * np.eye(model.C.shape[0]), device=device)
        return mpc, dt, n_replan, hz
    from soft_robot_control_tpu_torch.tasks.demo import make_demo_tpwl

    model = make_demo_tpwl(r=21, P=64, m=4, nz=6, nf=64, dtype=np.float32,
                           device=device)
    dt = 1.0 / hz
    mpc = BatchMPC(model, 100.0 * np.eye(6), 1e-3 * np.eye(4), N=5, dt=dt,
                   N_replan=1, qp_iters=50, use_pallas=True, dtype=dtype,
                   W=1e-2 * np.eye(model.state_dim),
                   V=1e-4 * np.eye(model.C.shape[0]), device=device)
    return mpc, dt, 1, hz


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(campaign=None, hz=50.0, seconds=5.0, device="cuda",
            dtype=torch.float32):
    """The paced loop: one window of `mpc.build(1)` a period, each call
    timed on the host clock to its synchronize, after a warm-up call and
    the median round trip of a trivial op (30 of them). Returns the
    script's summary and the last call's logs."""
    from soft_robot_control_tpu_torch.tasks.demo import demo_targets

    dev = resolve_device(device)
    mpc, dt, n_replan, hz = controller(campaign, hz, dev, dtype)
    step = mpc.build(1)
    n_steps = int(seconds * hz)
    zt = torch.as_tensor(demo_targets(mpc.model, 1, n_replan, mpc.N, dt,
                                      batch=1)[0], dtype=dtype, device=dev)
    x0 = torch.zeros(mpc.n_x, dtype=dtype, device=dev)
    step(x0, x0, zt)  # warm-up
    _sync(dev)

    tiny = torch.zeros(1, dtype=dtype, device=dev)
    rtt = []
    for _ in range(30):
        t0 = time.perf_counter()
        tiny * 2
        _sync(dev)
        rtt.append(time.perf_counter() - t0)
    rtt_ms = 1e3 * float(np.median(rtt))

    period = 1.0 / hz
    lat, misses = [], 0
    t_next = time.perf_counter()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        logs = step(x0, x0, zt)
        _sync(dev)
        dt_step = time.perf_counter() - t0
        lat.append(dt_step)
        if dt_step - 1e-3 * rtt_ms > period:
            misses += 1
        t_next += period
        sleep = t_next - time.perf_counter()
        if sleep > 0:
            time.sleep(sleep)
    lat = 1e3 * np.asarray(lat)
    net = lat - rtt_ms
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    res = {
        "campaign": campaign,
        "hz": float(hz),
        "deadline_ms": 1e3 * period,
        "rtt_ms_median": rtt_ms,
        "total_ms_mean": float(lat.mean()),
        "total_ms_p50": float(np.percentile(lat, 50)),
        "total_ms_p99": float(np.percentile(lat, 99)),
        "compute_ms_mean": float(net.mean()),
        "compute_ms_p50": float(np.percentile(net, 50)),
        "compute_ms_p99": float(np.percentile(net, 99)),
        "compute_budget_misses": int(misses),
        "n_steps": int(n_steps),
        "device": name,
    }
    return res, logs


def realtime_gates(res) -> list:
    """tests/test_campaign_artifacts.py's real-time gates on a summary: the
    list of those it fails."""
    fails = []
    if res["campaign"] != "diamond":
        fails.append("campaign is not diamond")
    if not res["compute_ms_mean"] < res["deadline_ms"]:
        fails.append("mean compute not under the deadline")
    if not res["compute_ms_p99"] < 2.0 * res["deadline_ms"]:
        fails.append("p99 compute not under twice the deadline")
    return fails


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hz", type=float, default=50.0)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--campaign", choices=["diamond"], default=None,
                   help="run on the committed campaign dictionary at its "
                        "dt=0.01 and N_replan=2")
    p.add_argument("--json", default=None,
                   help="write the latency summary to this path (for "
                        "example runs/realtime_mpc.json)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    res, _ = measure(args.campaign, args.hz, args.seconds, args.device)
    print(f"{res['hz']:.0f} Hz loop, {res['n_steps']} MPC steps on "
          f"{res['device']}")
    print(f"host round trip baseline (trivial op): "
          f"{res['rtt_ms_median']:.3f} ms")
    print(f"total latency ms: mean {res['total_ms_mean']:.3f} / p50 "
          f"{res['total_ms_p50']:.3f} / p99 {res['total_ms_p99']:.3f}")
    print(f"controller compute (total - round trip): mean "
          f"{res['compute_ms_mean']:.3f} ms / p99 "
          f"{res['compute_ms_p99']:.3f} ms")
    print(f"deadline {res['deadline_ms']:.1f} ms, compute-budget misses: "
          f"{res['compute_budget_misses']}/{res['n_steps']}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
        print(f"saved {args.json}")
    if args.campaign == "diamond":
        fails = realtime_gates(res)
        if fails:
            raise SystemExit(f"real-time gates failed: {fails}")
        print("real-time gates hold")
    return res


if __name__ == "__main__":
    main()
