"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: both CUDA kernels from soft_robot_control_tpu_torch/csrc, one
   nvcc each, started together;
3. kernel 1 (batched ADMM) against its plain PyTorch version on QPs that
   the port assembles from the Diamond campaign dictionary, in f64 and
   f32, at B=1024, 1 and 3;
4. kernel 2 (TPWL select and gather) against its plain version on 5120
   states near the campaign dictionary (P=1087, r=30);
5. the main path: BatchMPC, condensed, build_fused at B=1024 for 4 windows
   with bench.py's quality-gated settings, on the full campaign artifact.
   The tracking error against dynamically feasible targets must be
   <= 0.05, both kernels must have been launched, and a B=8 run must agree
   with the port's f64 CPU run of the same loop. A profiler pass records
   where the device time of one run goes.

The last three lines of standard output are the per-kernel JSON record,
the card's name and power limit, and {"ok": true, "device": {...}}. The
full record is also written to build/chip_smoke.json. Without a card
the script exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from soft_robot_control_tpu_torch.control.batch_mpc import (  # noqa: E402
    BatchMPC, equilibrate_qp, window_targets)
from soft_robot_control_tpu_torch.core.constraints import (  # noqa: E402
    HyperRectangle)
from soft_robot_control_tpu_torch.models.tpwl import (  # noqa: E402
    from_tpwl_dict, rollout_batch)
from soft_robot_control_tpu_torch.ops import build  # noqa: E402
from soft_robot_control_tpu_torch.ops.admm_batched import (  # noqa: E402
    admm_batched, admm_batched_plain)
from soft_robot_control_tpu_torch.ops.tpwl_select import (  # noqa: E402
    point_distances_batch, tpwl_select, tpwl_select_plain)
from soft_robot_control_tpu_torch.qp.blocked import make_kinv  # noqa: E402
from soft_robot_control_tpu_torch.scp.locp_condensed import (  # noqa: E402
    CondensedParams)
from soft_robot_control_tpu_torch.sim.measurement import (  # noqa: E402
    linearModel)

ARTIFACT = os.path.join(HERE, "examples", "diamond_tet",
                        "tpwl_model_snapshots.pkl")
KERNELS = ("admm_batched", "tpwl_select")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
QUALITY_GATE = 0.05         # bench.py's rel tracking error gate
ADMM_F64_TOL = 1e-9         # max abs error, kernel vs plain, f64
ADMM_F32_TOL = 1e-4         # max abs error over max(|w|, |y|, 1), f32
CPU_AGREE_TOL = 1e-4        # rel z difference, f32 card vs f64 CPU loop
NEAR_TIE = 1e-6             # f64 relative gap under which indices may differ
N, N_REPLAN, N_WIN, B_MAIN, B_CPU = 5, 2, 4, 1024, 8
ITERS = 100 // 4            # ADMM iterations per launch (100 in 4 stages)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() over `reps` back-to-back calls. A sleep
    kernel queued first keeps the stream busy while the host enqueues the
    calls, so host overhead between launches is not counted."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # ~0.2 s of device cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, flops):
    """Least time (ms) for the work on an H100, and what sets it."""
    t_b = bytes_moved / HBM_BYTES_PER_S
    t_f = flops / F32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def make_mpc(model, dtype, device):
    """BatchMPC at bench.py's quality-gated settings."""
    nz, m_in = model.H.shape[0], model.input_dim
    return BatchMPC(
        model, 100.0 * np.eye(nz), 1e-5 * np.eye(m_in), N=N, dt=0.01,
        N_replan=N_REPLAN, qp_iters=100, scp_iters=1, dtype=dtype,
        formulation="condensed",
        U=HyperRectangle(1500.0 * np.ones(m_in), np.zeros(m_in)),
        rho_stages=4, scaling_iters=6, W=1e-2 * np.eye(model.state_dim),
        V=1e-4 * np.eye(model.C.shape[0]), device=device)


def feasible_targets(model, B):
    """bench.py's quality targets: the model's own z-response to smooth
    admissible cable inputs, windowed (B, N_WIN, N+1, n_z)."""
    dt = model.pre_discretized_dt
    T_q = N_WIN * N_REPLAN + N + 1
    rng = np.random.default_rng(11)
    tq = dt * np.arange(T_q + 1)
    u_ref = 0.5 * 1500.0 * (1.0 + np.sin(
        2 * np.pi * tq[None, :, None] / 4.0
        + rng.uniform(0, 2 * np.pi, size=(B, 1, model.input_dim))))
    x0 = torch.zeros((B, model.state_dim), dtype=model.q.dtype,
                     device=model.device)
    X = rollout_batch(model, x0, torch.as_tensor(
        u_ref, dtype=model.q.dtype, device=model.device), dt)
    zq = (X @ model.H.T + model.z_ref).cpu().numpy()
    return np.stack([window_targets(zq[b, :T_q], N_WIN, N_REPLAN, N)
                     for b in range(B)])


def rel_track(z, zt):
    """bench.py's relative tracking error of logged z against the
    executed target entries 1..N_replan of each window."""
    B = z.shape[0]
    zt_exec = zt[:, :, 1:N_REPLAN + 1, :].reshape(B, N_WIN * N_REPLAN, -1)
    den = max(np.linalg.norm(zt_exec - zt_exec.mean(axis=(0, 1))), 1e-12)
    return float(np.linalg.norm(z - zt_exec) / den)


def admm_inputs(mpc, x, zt):
    """Stage-0 inputs of the ADMM kernel as the main path builds them: QPs
    linearized at the states x (B, n_x), equilibrated, rho folded into the
    rows, K^-1 from make_kinv, all in mpc's dtype."""
    B = x.shape[0]
    Ad, Bd, dd = mpc._gather_traj(x[:, None].expand(-1, N + 1, -1))
    z = torch.as_tensor(zt, dtype=x.dtype, device=x.device)
    P, q, A, l, u, _, _, _ = mpc.cspec.assemble(CondensedParams(
        Ad=Ad, Bd=Bd, dd=dd, x0=x, z=z - mpc.model.z_ref,
        u_des=torch.zeros((B, N, mpc.n_u), dtype=x.dtype, device=x.device)))
    w0 = torch.zeros((B, mpc.cspec.n_var), dtype=x.dtype, device=x.device)
    y0 = torch.zeros((B, mpc.cspec.n_con), dtype=x.dtype, device=x.device)
    P, q, A, l, u, w0, y0, _ = equilibrate_qp(P, q, A, l, u, w0, y0, 6)
    srt = torch.sqrt(mpc.rho_vec_c)
    ones = torch.ones_like(srt)
    As = A * srt[None, :, None]
    return [make_kinv(P, As, ones), As, q, srt * l, srt * u, ones, w0,
            y0 / srt]


def phase_admm(mpc64, mpc, x_qp, zt, card):
    out = {}
    for m in (mpc64, mpc):
        args = admm_inputs(m, x_qp.to(m.dtype), zt[:, 0])
        for B in (B_MAIN, 1, 3):
            a = [t[:B] if t.dim() > 1 else t for t in args]
            w1, y1 = admm_batched(*a, ITERS)
            w2, y2 = admm_batched_plain(*a, ITERS)
            torch.cuda.synchronize()
            err = max(float((w1 - w2).abs().max()),
                      float((y1 - y2).abs().max()))
            scale = max(float(w2.abs().max()), float(y2.abs().max()), 1.0)
            tag = f"{str(m.dtype)[6:]} B={B}"
            out[tag] = {"max_abs_err": err, "scale": scale}
            print(f"[admm_batched] {tag}: max abs err {err:.3e} "
                  f"(solution scale {scale:.3e})")
            check(bool(torch.isfinite(w1).all() and torch.isfinite(y1).all()),
                  f"admm_batched {tag}: non-finite output")
            tol = ADMM_F64_TOL if m.dtype == torch.float64 else (
                ADMM_F32_TOL * scale)
            check(err <= tol, f"admm_batched {tag}: error {err} > {tol}")
    B, n, mc = B_MAIN, args[2].shape[1], args[3].shape[1]
    ms = cuda_ms(lambda: admm_batched(*args, ITERS), 50)
    plain_ms = cuda_ms(lambda: admm_batched_plain(*args, ITERS), 5)
    # inputs read once, outputs written once; per iteration three
    # mat-vecs (A^T, K^-1, A) and the element-wise updates
    nbytes = 4 * (B * n * n + B * mc * n + 3 * B * n + 4 * B * mc + mc)
    flops = B * (2 * mc * n + 2 * mc + ITERS * (
        4 * mc * n + 2 * n * n + 5 * n + 12 * mc))
    bound_ms, bound_by = bound(nbytes, flops)
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, flops=flops,
               shape=f"B={B}, n={n}, m={mc}, iters={ITERS}, f32")
    print(f"[admm_batched] f32 B={B} n={n} m={mc} {ITERS} iters: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}]")
    return out


def phase_select(model64, model, x64, card):
    d64 = point_distances_batch(x64, model64.q, model64.v, model64.dist_w_q,
                                model64.dist_w_v)
    two = torch.topk(d64, 2, dim=1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) < NEAR_TIE * two[:, 0]
    out = {"near_ties": int(near_tie.sum())}
    for mdl in (model64, model):
        x = x64.to(mdl.q.dtype)
        tag = str(x.dtype)[6:]
        dic = (mdl.q, mdl.v, mdl.A_d, mdl.B_d, mdl.d_d, mdl.dist_w_q,
               mdl.dist_w_v)
        got = tpwl_select(x, *dic)
        ref = tpwl_select_plain(x, *dic)
        torch.cuda.synchronize()
        same = got[0] == ref[0]
        check(bool((same | near_tie).all()),
              f"tpwl_select {tag}: {int((~same & ~near_tie).sum())} index "
              "differences away from near-ties")
        err = max(float((a[same] - b[same]).abs().max())
                  for a, b in zip(got[1:], ref[1:]))
        check(err == 0.0, f"tpwl_select {tag}: gathered rows differ")
        out[tag] = {"index_differences": int((~same).sum()), "max_abs_err":
                    err, "distinct_points": int(torch.unique(got[0]).numel())}
        print(f"[tpwl_select] {tag} B={x.shape[0]}: "
              f"{out[tag]['index_differences']} index differences, all at "
              f"near-ties (f64 gap < {NEAR_TIE} rel; {out['near_ties']} "
              f"near-ties), gathered rows bitwise equal, "
              f"{out[tag]['distinct_points']} distinct points")
    dic = (model.q, model.v, model.A_d, model.B_d, model.d_d,
           model.dist_w_q, model.dist_w_v)
    P, r = model.q.shape
    n, mu = model.B_d.shape[1:]
    row = n * n + n * mu + n
    xs = x64.float()
    for B in (N * B_MAIN, (1 + N_REPLAN) * B_MAIN):  # plan, tick launches
        xb = xs[:B]
        n_rows = int(torch.unique(tpwl_select(xb, *dic)[0]).numel())
        ms = cuda_ms(lambda: tpwl_select(xb, *dic), 50)
        plain_ms = cuda_ms(lambda: tpwl_select_plain(xb, *dic), 5)
        # states and dictionary coordinates read once, the rows this data
        # selects read once, the gathered rows and indices written once;
        # per state and point 3 operations a coordinate, 2 roots, 3 more
        nbytes = 4 * (B * 2 * r + P * 2 * r + n_rows * row + B * row) + 8 * B
        flops = B * P * (6 * r + 5)
        bound_ms, bound_by = bound(nbytes, flops)
        out[f"B={B}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bytes=nbytes, flops=flops,
                             distinct_rows=n_rows)
        print(f"[tpwl_select] f32 B={B} P={P}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) "
              f"[{card}]")
    return out


def phase_main(mpc, model64, zt, card):
    run = mpc.build_fused(N_WIN)
    x0 = torch.zeros((B_MAIN, mpc.n_x), dtype=torch.float32,
                     device=mpc.device)
    admm_batched.launches = 0
    tpwl_select.launches = 0
    logs = run(x0, x0, zt)
    torch.cuda.synchronize()
    launches = {"admm_batched": admm_batched.launches,
                "tpwl_select": tpwl_select.launches}
    print(f"[main] launches in one build_fused run of {N_WIN} windows at "
          f"B={B_MAIN}: {launches}")
    for name, want in (("admm_batched", 4 * N_WIN),
                       ("tpwl_select", (1 + N_REPLAN) * N_WIN)):
        check(launches[name] == want,
              f"{name} launched {launches[name]} times, expected {want}")
    z, u = logs["z"].cpu().numpy(), logs["u"].cpu().numpy()
    check(z.shape == (B_MAIN, N_WIN * N_REPLAN, mpc.n_z)
          and u.shape == (B_MAIN, N_WIN * N_REPLAN, mpc.n_u),
          f"log shapes {z.shape}, {u.shape}")
    check(np.isfinite(z).all() and np.isfinite(u).all(), "non-finite logs")
    check(u.min() >= 0.0 and u.max() <= 1500.0, "command outside [0, 1500]")
    track = rel_track(z, zt)
    print(f"[main] rel tracking error {track:.5f} (gate {QUALITY_GATE})")
    check(track <= QUALITY_GATE, f"rel tracking error {track}")

    # host clock around whole runs: the loop is host-bound (see below), so
    # the spread of ten runs is kept beside their median
    runs_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(x0, x0, zt)
        torch.cuda.synchronize()
        runs_ms.append(1e3 * (time.perf_counter() - t0))
    t_run = float(np.median(runs_ms)) / 1e3
    windows_per_s = B_MAIN * N_WIN / t_run
    print(f"[main] {windows_per_s:.1f} windows/s (median of 10 runs: "
          f"{1e3 * t_run:.2f} ms per {N_WIN}-window run at B={B_MAIN}, f32; "
          f"min {min(runs_ms):.2f}, max {max(runs_ms):.2f} ms) [{card}]")
    out = dict(launches=launches, rel_track=track,
               windows_per_s=windows_per_s, run_ms=1e3 * t_run,
               runs_ms=runs_ms)

    # where the time of one run goes: device time by kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(x0, x0, zt)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    out.update(device_ms=dev_ms, device_busy_share=dev_ms / (1e3 * t_run),
               top_device_ops=[{"name": e.key[:90],
                                "ms": e.self_device_time_total / 1e3,
                                "calls": e.count} for e in top])
    print(f"[main] device busy {dev_ms:.2f} ms of {1e3 * t_run:.2f} ms per "
          f"run (share {out['device_busy_share']:.3f}); top device time:")
    for e in out["top_device_ops"]:
        print(f"[main]   {e['ms']:8.3f} ms  {e['calls']:5d}x  {e['name']}")

    # the same loop at B=8 against the port's f64 run on the CPU
    cpu_mpc = make_mpc(model64.to(device="cpu"), torch.float64, "cpu")
    x0c = np.zeros((B_CPU, mpc.n_x))
    ref = cpu_mpc.build_fused(N_WIN)(x0c, x0c, zt[:B_CPU])["z"].numpy()
    got = run(x0[:B_CPU], x0[:B_CPU], zt[:B_CPU])["z"].cpu().numpy()
    agree = float(np.linalg.norm(got - ref)
                  / np.linalg.norm(ref - ref.mean(axis=(0, 1))))
    print(f"[main] B={B_CPU}: f32 card vs f64 CPU rel z difference "
          f"{agree:.3e} (tol {CPU_AGREE_TOL})")
    check(agree <= CPU_AGREE_TOL, f"card vs CPU difference {agree}")
    out["cpu_rel_diff"] = agree
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    rec = {}
    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec["card"] = card
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    # 2. build
    rec["build_s"] = build.build_kernels(KERNELS)
    print(f"[build] {', '.join(KERNELS)} for sm_90a in "
          f"{rec['build_s']:.1f} s")
    for name in KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    Cf = linearModel([1354, 726, 139, 1445, 729], 1628).C_dense()
    Hf = linearModel([1354], 1628, vel=False).C_dense()
    model64 = from_tpwl_dict(
        ARTIFACT, params={"dist_weights": {"q": 10.0, "v": 1.0}}, Cf=Cf,
        Hf=Hf, discr_method="be", device=dev).to(dtype=torch.float64)
    model = model64.to(dtype=torch.float32)
    t0 = time.perf_counter()
    mpc = make_mpc(model, torch.float32, dev)
    torch.cuda.synchronize()
    print(f"[model] campaign P={model.num_points}, n_x={model.state_dim}, "
          f"n_u={model.input_dim}, n_y={mpc.n_y}, n_z={mpc.n_z}; BatchMPC "
          f"set-up (1087 DARE gains) {time.perf_counter() - t0:.2f} s")
    zt = feasible_targets(model, B_MAIN)

    # states near the dictionary: its points plus seeded noise
    rng = np.random.default_rng(3)
    X_pts = torch.cat([model64.v, model64.q], dim=1)
    pts = torch.as_tensor(rng.integers(0, model.num_points, N * B_MAIN),
                          device=dev)
    noise = torch.as_tensor(rng.normal(size=(N * B_MAIN, model.state_dim)),
                            device=dev)
    x_near = X_pts[pts] + 0.05 * X_pts.std(dim=0) * noise

    # 3.-5.
    rec["admm_batched"] = phase_admm(make_mpc(model64, torch.float64, dev),
                                     mpc, x_near[:B_MAIN], zt, card)
    rec["tpwl_select"] = phase_select(model64, model, x_near, card)
    rec["main"] = phase_main(mpc, model64, zt, card)

    k1, k2 = rec["admm_batched"], rec["tpwl_select"][f"B={N * B_MAIN}"]
    launches = rec["main"]["launches"]
    src = "soft_robot_control_tpu_torch/csrc/"
    kernels = [
        {"name": "admm_batched", "route": "cuda",
         "source": src + "admm_batched.cu",
         "replaces": "soft_robot_control_tpu/ops/pallas_admm.py:132",
         "launches": launches["admm_batched"],
         "max_abs_err": k1[f"float32 B={B_MAIN}"]["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None},
        # max_abs_err: over the gathered rows where the indices agree;
        # phase 4 fails on any index difference that is not a near-tie
        {"name": "tpwl_select", "route": "cuda",
         "source": src + "tpwl_select.cu",
         "replaces": "soft_robot_control_tpu/ops/pallas_tpwl.py:24",
         "launches": launches["tpwl_select"],
         "max_abs_err": rec["tpwl_select"]["float32"]["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
    ]
    rec["kernels"] = kernels
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
