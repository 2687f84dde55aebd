"""Batched MPC serving, the throughput path: B independent closed-loop
MPC+EKF controllers on the synthetic demo model (condensed LOCP, one launch
of the batched ADMM kernel a rho stage a window) on one card, or split over
a mesh's dp axis with `--mesh`: the twin of examples/batched_serving.py on
the port.

    python -m soft_robot_control_tpu_torch.examples.batched_serving \
        [--batch 1024] [--windows 8] [--mesh 4] [--formulation sparse] \
        [--device cpu]

`--mesh N` makes a dp=N mesh of the visible cards, each taken as often as
N needs (on one card, N parts of the batch in turn).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from soft_robot_control_tpu_torch.utils.device import resolve_device


def serving_mpc(formulation="condensed", device="cuda", dtype=torch.float32):
    """The script's BatchMPC on make_demo_tpwl(r=21, P=64, m=4, nz=6, nf=64):
    N=5, dt=0.02, N_replan=2, 50 ADMM iterations, K^-1 x-step."""
    from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
    from soft_robot_control_tpu_torch.tasks.demo import make_demo_tpwl

    model = make_demo_tpwl(r=21, P=64, m=4, nz=6, nf=64, dtype=np.float32,
                           device=device)
    return BatchMPC(model, 100.0 * np.eye(6), 1e-3 * np.eye(4), N=5, dt=0.02,
                    N_replan=2, qp_iters=50, scp_iters=1, dtype=dtype,
                    x_step="kinv", formulation=formulation,
                    W=1e-2 * np.eye(model.state_dim),
                    V=1e-4 * np.eye(model.C.shape[0]), device=device)


def mesh_devices(n: int, device):
    """n devices for a dp=n mesh: the visible cards in turn on a card, the
    CPU n times on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    return [torch.device("cuda", i % torch.cuda.device_count())
            for i in range(n)]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(batch=1024, windows=8, mesh=0, formulation="condensed",
          device="cuda", dtype=torch.float32, timed=5):
    """The script's run: the loop built (split over a dp=`mesh` mesh when
    mesh > 0) and called once, then `timed` calls timed on the host clock
    behind a synchronize. Returns the logs of the first call, its seconds
    and the windows a second."""
    from soft_robot_control_tpu_torch.tasks.demo import demo_targets

    dev = resolve_device(device)
    mpc = serving_mpc(formulation, dev, dtype)
    B, n_win = batch, windows
    zt = torch.as_tensor(demo_targets(mpc.model, n_win, mpc.N_replan, mpc.N,
                                      mpc.dt, batch=B), dtype=dtype,
                         device=dev)
    x0 = torch.zeros((B, mpc.n_x), dtype=dtype, device=dev)
    if mesh:
        from soft_robot_control_tpu_torch.parallel.mesh import (
            make_mesh, sharded_batch_mpc_fused)

        run = sharded_batch_mpc_fused(
            mpc, n_win, make_mesh(mesh, 1, devices=mesh_devices(mesh, dev)))
    else:
        run = mpc.build_fused(n_win)
    t0 = time.perf_counter()
    logs = run(x0, x0, zt)
    _sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(timed):
        run(x0, x0, zt)
    _sync(dev)
    wps = B * n_win * timed / (time.perf_counter() - t0)
    return {"logs": logs, "first_call_s": first_s, "windows_per_s": wps}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--mesh", type=int, default=0,
                    help="split over a dp mesh of this many devices "
                         "(0 = one device)")
    ap.add_argument("--formulation", default="condensed",
                    choices=["condensed", "sparse"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.batch < 1 or args.windows < 1:
        ap.error("--batch and --windows must be >= 1")
    if args.mesh:
        print(f"mesh: dp={args.mesh}")
    print(f"running ({args.formulation}, B={args.batch}, {args.windows} "
          "windows)...")
    out = serve(args.batch, args.windows, args.mesh, args.formulation,
                args.device)
    print(f"  first call: {out['first_call_s']:.1f} s")
    z = out["logs"]["z"]
    if not bool(torch.isfinite(z).all()):
        raise RuntimeError("batched serving: non-finite outputs")
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"throughput: {out['windows_per_s']:,.0f} MPC windows/s "
          f"({args.batch}-way, device {name})")
    return out


if __name__ == "__main__":
    main()
