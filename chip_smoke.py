"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the five CUDA kernels from soft_robot_control_tpu_torch/csrc, one
   nvcc each, started together;
3. kernel 1 (batched ADMM for QPs that fit a block) against its plain
   PyTorch version on condensed QPs (n=20, m=40, its register form) that
   the port assembles from the Diamond campaign dictionary, and on random
   QPs of n=100, m=120 (its shared form), in f64 and f32, at B=1024, 1, 3;
   timed at B=1024 with 25 iterations and with none, whose difference is
   the time of the iterations apart from the loads;
4. kernel 2 (TPWL select and gather) against its plain version on 5120
   states near the campaign dictionary (P=1087, r=30), at B=5120, at a
   ragged B=5119, and at B=3072 with rows for the last two thirds only
   (index_only=1024, as the tick calls it); timed as the plan launch
   (B=5120), the tick launch (B=3072, index_only=1024) and an index-only
   launch (B=5120, index_only=5120: the select without the gather);
5. kernel 3 in its two forms against the same plain version on sparse QPs
   (n=380, m=400, one-sided rows with infinite bounds) assembled,
   equilibrated and rho-folded as the fused sparse loop builds them, at
   B=64, 1, 3, each timed at B=1024 in f32: the streaming form
   (admm_stream, QP re-read from device memory every iteration) in f64 and
   f32; the cluster-resident form (admm_cluster, QP held across a
   thread-block cluster's shared memory) in f32 and, since the f64 QP of
   that size fits no cluster, in f64 on the same loop's QPs at horizon 3
   (n=252, m=264). The clusters the card holds at one time are printed,
   and clusters of 6 and of 8 blocks are timed in turns;
6. kernel 4 (single-QP ADMM through M1, one cluster) against its plain
   version on one such QP prepared as the single-trajectory loop prepares
   it, f64 (walked in place through L2) and f32 (resident), 50 iterations;
7. the condensed path: BatchMPC, condensed, build_fused at B=1024 for 4
   windows with bench.py's quality-gated settings, on the full campaign
   artifact. The tracking error against dynamically feasible targets must
   be <= 0.05, kernels 1 and 2 must have been launched 4 and 3 times a
   window, and B=8 runs on the card, in f32 and in f64, must agree with
   the port's f64 CPU run of the same loop. A profiler pass records where
   the device time of one run goes;
8. path A, the fused sparse loop: BatchMPC, sparse, build_fused at B=1024
   for 4 windows (K^-1 x-step, 100 iterations in 4 rho stages, 6 Ruiz
   iterations, R = 1e-5 I), with the same checks through admm_cluster and
   kernel 2 in f32, plus the peak device memory; its f64 run on the card
   must go through admm_stream;
9. path B, the single-trajectory sparse loop: BatchMPC(use_pallas=True),
   build for 10 windows (50 iterations, R = 1e-3 I): one launch of kernel 4
   and three of kernel 2 a window, finite logs, agreement of the f32 and
   the f64 card runs with the f64 CPU run, and a profiler pass.

Every launch count is set to 0 just before a path is driven and read just
after. The last three lines of standard output are the per-kernel JSON
record, the card's name and power limit, and {"ok": true, "device":
{...}}. The full record is also written to build/chip_smoke.json. Without
a card the script exits non-zero before printing any result. It takes about
two minutes on an H100, the build included.
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
    admm_batched, admm_batched_plain, admm_cluster, admm_stream,
    cluster_max_active, cluster_plan_built)
from soft_robot_control_tpu_torch.ops.admm_single import (  # noqa: E402
    admm_single, admm_single_plain, prepare_single)
from soft_robot_control_tpu_torch.ops.tpwl_select import (  # noqa: E402
    point_distances_batch, tpwl_select, tpwl_select_plain)
from soft_robot_control_tpu_torch.qp.blocked import make_kinv  # noqa: E402
from soft_robot_control_tpu_torch.scp.locp import LOCPParams  # noqa: E402
from soft_robot_control_tpu_torch.scp.locp_condensed import (  # noqa: E402
    CondensedParams)
from soft_robot_control_tpu_torch.sim.measurement import (  # noqa: E402
    linearModel)

ARTIFACT = os.path.join(HERE, "examples", "diamond_tet",
                        "tpwl_model_snapshots.pkl")
KERNELS = ("admm_batched", "tpwl_select", "admm_stream", "admm_cluster",
           "admm_single")
WRAPPERS = {"admm_batched": admm_batched, "tpwl_select": tpwl_select,
            "admm_stream": admm_stream, "admm_cluster": admm_cluster,
            "admm_single": admm_single}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
QUALITY_GATE = 0.05         # bench.py's rel tracking error gate
ADMM_F64_TOL = 1e-9         # max abs error, kernel vs plain, f64
ADMM_F32_TOL = 1e-4         # max abs error over max(|w|, |y|, 1), f32
CPU_AGREE_TOL = 1e-4        # rel z difference, f32 card vs f64 CPU loop
# The sparse QP keeps the dynamics as equality rows with a 1e3 rho boost,
# and K^-1 of that KKT amplifies f32 rounding: in the kernels' sums, which
# run in another order than the plain version's (measured on an H100: up to
# 3.7e-4 of the solution's scale for kernel 3, 5e-5 for kernel 4), and, in
# the loops, in the library factorizations around them alike (measured f32
# card against f64 CPU: 4.4e-3 on path A, 2.1e-2 on path B, whose
# R = 1e-3 I keeps the output's own variation, the denominator, small).
# The f64 card runs of the same loops are therefore held to the f64 CPU
# runs too, at F64_CPU_AGREE_TOL: that comparison is the one that would
# show a kernel at fault inside a loop.
SPARSE_F32_TOL = 1e-3
PATH_A_CPU_AGREE_TOL = 1e-2
PATH_B_CPU_AGREE_TOL = 5e-2
F64_CPU_AGREE_TOL = 1e-6    # rel z difference, f64 card vs f64 CPU loop
NEAR_TIE = 1e-6             # f64 relative gap under which indices may differ
N, N_REPLAN, N_WIN, B_MAIN, B_CPU = 5, 2, 4, 1024, 8
N_F64_CLUSTER = 3           # horizon whose f64 sparse QP fits a cluster
N_WIN_B = 10                # windows of the single-trajectory path
ITERS = 100 // 4            # ADMM iterations per launch (100 in 4 stages)
ITERS_B = 50                # iterations of the single-QP launch


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


def clocks():
    """The card's SM clock, its maximum, power draw and temperature now, as
    nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]


def bound(bytes_moved, flops):
    """Least time (ms) for the work on an H100, and what sets it."""
    t_b = bytes_moved / HBM_BYTES_PER_S
    t_f = flops / F32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in WRAPPERS.items()}


def make_mpc(model, dtype, device, path="condensed", horizon=N):
    """BatchMPC at bench.py's settings: 'condensed' and 'A' (sparse) are
    the quality-gated fused loops, 'B' the single-trajectory sparse loop
    through the single-QP kernel."""
    nz, m_in = model.H.shape[0], model.input_dim
    kw = dict(N=horizon, dt=0.01, N_replan=N_REPLAN, scp_iters=1, dtype=dtype,
              U=HyperRectangle(1500.0 * np.ones(m_in), np.zeros(m_in)),
              W=1e-2 * np.eye(model.state_dim),
              V=1e-4 * np.eye(model.C.shape[0]), device=device)
    if path == "B":
        return BatchMPC(model, 100.0 * np.eye(nz), 1e-3 * np.eye(m_in),
                        qp_iters=ITERS_B, use_pallas=True, **kw)
    return BatchMPC(
        model, 100.0 * np.eye(nz), 1e-5 * np.eye(m_in), qp_iters=100,
        x_step="kinv", rho_stages=4, scaling_iters=6,
        formulation="condensed" if path == "condensed" else "sparse", **kw)


def feasible_targets(model, B, n_win):
    """bench.py's quality targets: the model's own z-response to smooth
    admissible cable inputs, windowed (B, n_win, N+1, n_z)."""
    dt = model.pre_discretized_dt
    T_q = n_win * N_REPLAN + N + 1
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
    return np.stack([window_targets(zq[b, :T_q], n_win, N_REPLAN, N)
                     for b in range(B)])


def rel_track(z, zt):
    """bench.py's relative tracking error of logged z (B, T, n_z) against
    the executed target entries 1..N_replan of each window of zt."""
    B, n_win = zt.shape[:2]
    zt_exec = zt[:, :, 1:N_REPLAN + 1, :].reshape(B, n_win * N_REPLAN, -1)
    den = max(np.linalg.norm(zt_exec - zt_exec.mean(axis=(0, 1))), 1e-12)
    return float(np.linalg.norm(z - zt_exec) / den)


def window_qps(mpc, x, zt):
    """The first window's QPs (P, q, A, l, u, w0, y0) as mpc's loop builds
    them: linearized at the states x (B, n_x), assembled with mpc's spec
    over mpc's horizon, Ruiz-equilibrated, with a cold start."""
    B, N = x.shape[0], mpc.N
    x_plan = x[:, None].expand(-1, N + 1, -1)
    Ad, Bd, dd = mpc._gather_traj(x_plan)
    z = torch.as_tensor(zt[:, :N + 1], dtype=x.dtype,
                        device=x.device) - mpc.model.z_ref
    zeros = lambda *shape: torch.zeros((B,) + shape, dtype=x.dtype,
                                       device=x.device)
    if mpc.formulation == "condensed":
        qp = mpc.cspec.assemble(CondensedParams(
            Ad=Ad, Bd=Bd, dd=dd, x0=x, z=z, u_des=zeros(N, mpc.n_u)))[:5]
    else:
        qp = mpc.spec.assemble(LOCPParams(
            Ad=Ad, Bd=Bd, dd=dd, x0=x, xk=x_plan, delta=mpc.delta0,
            omega=mpc.omega0, z=z, zf=zeros(mpc.n_z),
            u_des=zeros(N, mpc.n_u)))[:5]
    n_var, n_con = mpc._qp_dims()
    return equilibrate_qp(*qp, zeros(n_var), zeros(n_con),
                          mpc.scaling_iters)[:7]


def admm_inputs(mpc, x, zt):
    """Stage-0 inputs of the batched ADMM kernels as the fused loop builds
    them: rho folded into the rows, K^-1 from make_kinv."""
    P, q, A, l, u, w0, y0 = window_qps(mpc, x, zt)
    rho = mpc.rho_vec_c if mpc.formulation == "condensed" else mpc.rho_vec
    srt = torch.sqrt(rho)
    ones = torch.ones_like(srt)
    As = A * srt[None, :, None]
    return [make_kinv(P, As, ones), As, q, srt * l, srt * u, ones, w0,
            y0 / srt]


def compare(name, tag, got, ref, dtype, tol_f32, f64_scaled=False):
    """Max abs error of a kernel's (w, y) against its plain version's;
    fails beyond 1e-9 (f64; times the solution's scale where `f64_scaled`,
    for the sparse QPs, whose duals reach 1e4) or tol_f32 times the
    solution's scale (f32)."""
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(max(float(b.abs().max()) for b in ref), 1.0)
    print(f"[{name}] {tag}: max abs err {err:.3e} (solution scale "
          f"{scale:.3e})")
    check(all(bool(torch.isfinite(a).all()) for a in got),
          f"{name} {tag}: non-finite output")
    if dtype == torch.float64:
        tol = ADMM_F64_TOL * (scale if f64_scaled else 1.0)
    else:
        tol = tol_f32 * scale
    check(err <= tol, f"{name} {tag}: error {err} > {tol}")
    return {"max_abs_err": err, "scale": scale}


def random_qps(B, n, m, seed, dtype, device):
    """B random feasible QPs of n variables and m rows with K^-1 from
    make_kinv (built in f64), a shared rho row, and infinite bounds on the
    first m // 8 rows (no lower) and the next m // 8 (no upper); the
    kernels' argument list."""
    rng = np.random.default_rng(seed)
    Ph = torch.as_tensor(rng.normal(size=(B, n, n)), device=device)
    P = Ph @ Ph.transpose(1, 2) + 0.1 * torch.eye(
        n, dtype=torch.float64, device=device)
    A = torch.as_tensor(rng.normal(size=(B, m, n)), device=device)
    mid = torch.einsum("bmn,bn->bm", A, torch.as_tensor(
        0.2 * rng.normal(size=(B, n)), device=device))
    rho = torch.full((m,), 0.1, dtype=torch.float64, device=device)
    half = torch.as_tensor(rng.uniform(0.1, 1, (2, B, m)), device=device)
    l, u = mid - half[0], mid + half[1]
    l[:, :m // 8] = -float("inf")
    u[:, m // 8:2 * (m // 8)] = float("inf")
    args = [make_kinv(P, A, rho), A, torch.as_tensor(
        rng.normal(size=(B, n)), device=device), l, u, rho,
        torch.as_tensor(0.1 * rng.normal(size=(B, n)), device=device),
        torch.as_tensor(0.1 * rng.normal(size=(B, m)), device=device)]
    return [t.to(dtype) for t in args]


def check_sizes(wrapper, args, sizes, tag, tol_f32, f64_scaled, out):
    """wrapper against admm_batched_plain on the first B QPs of args, for B
    in `sizes`; each result goes into out under `tag` B=..."""
    name = wrapper.__name__
    for B in sizes:
        a = [t[:B] if t.dim() > 1 else t for t in args]
        count = wrapper.launches
        got = wrapper(*a, ITERS)
        check(wrapper.launches == count + 1,
              f"{name} did not launch its kernel")
        key = f"{tag} B={B}"
        out[key] = compare(name, key, got, admm_batched_plain(*a, ITERS),
                           args[0].dtype, tol_f32, f64_scaled=f64_scaled)


def admm_work(B, n, mc, iters):
    """Bytes (inputs read once, outputs written once, f32) and operations
    (per iteration three mat-vecs, A^T, K^-1, A, and the element-wise
    updates) of B fixed-iteration ADMM solves."""
    nbytes = 4 * (B * n * n + B * mc * n + 3 * B * n + 4 * B * mc + mc)
    flops = B * (2 * mc * n + 2 * mc + iters * (
        4 * mc * n + 2 * n * n + 5 * n + 12 * mc))
    return nbytes, flops


def phase_admm(wrapper, mpc64, mpc, x_qp, zt, card, sizes, tol_f32, reps,
               cluster_sizes=(), other_size=None):
    """A batched ADMM kernel against admm_batched_plain at the batch sizes
    `sizes`, f64 (on mpc64's QPs) and f32 (on mpc's), then timed at B_MAIN
    in f32, also with no iterations; `other_size` (n, m) repeats the checks
    and the timing on random QPs of that size; `cluster_sizes` are also
    timed, in turns, where the wrapper takes a cluster size."""
    name = wrapper.__name__
    out = {}
    for m in (mpc64, mpc):
        B_in = B_MAIN if m is mpc else max(sizes)
        args = admm_inputs(m, x_qp[:B_in].to(m.dtype), zt[:B_in, 0])
        n_inf = int(torch.isinf(args[3][0]).sum()
                    + torch.isinf(args[4][0]).sum())
        print(f"[{name}] {str(m.dtype)[6:]} QPs of n={args[2].shape[1]}, "
              f"m={args[3].shape[1]} with {n_inf} infinite bounds each")
        check_sizes(wrapper, args, sizes, str(m.dtype)[6:], tol_f32,
                    m.formulation == "sparse", out)
    B, n, mc = B_MAIN, args[2].shape[1], args[3].shape[1]
    ms = cuda_ms(lambda: wrapper(*args, ITERS), reps)
    ms0 = cuda_ms(lambda: wrapper(*args, 0), reps)
    out["clocks"] = clocks()
    plain_ms = cuda_ms(lambda: admm_batched_plain(*args, ITERS), 3)
    nbytes, flops = admm_work(B, n, mc, ITERS)
    bound_ms, bound_by = bound(nbytes, flops)
    us_iter = 1e3 * (ms - ms0) / ITERS
    out.update(ms=ms, ms_no_iterations=ms0, us_per_iteration=us_iter,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops,
               shape=f"B={B}, n={n}, m={mc}, iters={ITERS}, f32")
    print(f"[{name}] f32 B={B} n={n} m={mc} {ITERS} iters: kernel "
          f"{ms:.4f} ms ({ms0:.4f} ms with no iteration: {us_iter:.3f} us "
          f"an iteration), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}; after it SM clock, max, power, temperature: "
          f"{out['clocks']}]")
    if other_size is not None:
        n2, m2 = other_size
        for dt in (torch.float64, torch.float32):
            a2 = random_qps(max(sizes), n2, m2, 17, dt, mpc.device)
            check_sizes(wrapper, a2, sizes, f"{str(dt)[6:]} n={n2} m={m2}",
                        tol_f32, False, out)
        ms2 = cuda_ms(lambda: wrapper(*a2, ITERS), reps)
        ms20 = cuda_ms(lambda: wrapper(*a2, 0), reps)
        b2, f2 = admm_work(B, n2, m2, ITERS)
        bound2, by2 = bound(b2, f2)
        out[f"n={n2} m={m2}"] = dict(ms=ms2, ms_no_iterations=ms20,
                                    bound_ms=bound2, bound_by=by2)
        print(f"[{name}] f32 B={B} n={n2} m={m2} {ITERS} iters: kernel "
              f"{ms2:.4f} ms ({ms20:.4f} ms with no iteration), bound "
              f"{bound2:.5f} ms ({by2}) [{card}]")
    if cluster_sizes:
        plan = cluster_plan_built(n, mc, 4)
        print(f"[{name}] default plan at n={n}, m={mc}, f32: {plan}")
        out["plan"] = plan
        out["by_cluster_size"] = {}
        turns = tuple(cluster_sizes) + tuple(reversed(cluster_sizes))
        for R in turns:
            t = cuda_ms(lambda: wrapper(*args, ITERS, cluster_size=R), reps)
            by = out["by_cluster_size"].setdefault(R, {
                "max_active_clusters": cluster_max_active(n, mc, 4, R),
                "block_bytes": cluster_plan_built(n, mc, 4, R)[
                    "block_bytes"], "ms": []})
            by["ms"].append(t)
        for R, by in out["by_cluster_size"].items():
            waves = -(-B // by["max_active_clusters"])
            print(f"[{name}] clusters of {R}: {by['block_bytes']} bytes a "
                  f"block, {by['max_active_clusters']} clusters (QPs) in "
                  f"flight, {waves} waves at B={B}; "
                  f"{' / '.join(f'{t:.4f}' for t in by['ms'])} ms [{card}]")
    return out


def phase_single(mpc64, mpc, x_qp, zt, card):
    """The single-QP kernel against admm_single_plain on one sparse QP
    prepared as admm_fixed_single prepares it, f64 and f32, then timed."""
    out = {}
    for m in (mpc64, mpc):
        P, q, A, l, u, w0, y0 = (t[0] for t in window_qps(
            m, x_qp[:1].to(m.dtype), zt[:1, 0]))
        M1, l_f, u_f = prepare_single(P, A, l, u, m.rho_vec)
        args = [M1, A, q, l_f, u_f, m.rho_vec, w0, y0]
        count = admm_single.launches
        got = admm_single(*args, ITERS_B)
        check(admm_single.launches == count + 1,
              "admm_single did not launch its kernel")
        tag = str(m.dtype)[6:]
        out[tag] = compare("admm_single", tag, got,
                           admm_single_plain(*args, ITERS_B), m.dtype,
                           SPARSE_F32_TOL, f64_scaled=True)
    n, mc = q.shape[0], l.shape[0]
    ms = cuda_ms(lambda: admm_single(*args, ITERS_B), 20)
    plain_ms = cuda_ms(lambda: admm_single_plain(*args, ITERS_B), 3)
    # M1, A and the vectors read once, (w, y) written once; per iteration
    # four mat-vecs (A^T, M1, M1^T, A) and the element-wise updates
    nbytes = 4 * (n * n + mc * n + 3 * n + 5 * mc)
    flops = 2 * mc * n + 2 * mc + ITERS_B * (
        4 * mc * n + 4 * n * n + 5 * n + 12 * mc)
    bound_ms, bound_by = bound(nbytes, flops)
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, flops=flops,
               shape=f"n={n}, m={mc}, iters={ITERS_B}, f32")
    print(f"[admm_single] f32 n={n} m={mc} {ITERS_B} iters: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}]")
    return out


def phase_select(model64, model, x64, card):
    """Kernel 2 against its plain version: identical indices away from
    near-ties and bitwise-equal rows, f64 and f32, at B=5120, a ragged
    B=5119 and B=3072 with index_only=1024; then the plan, tick and
    index-only launches timed in f32."""
    d64 = point_distances_batch(x64, model64.q, model64.v, model64.dist_w_q,
                                model64.dist_w_v)
    two = torch.topk(d64, 2, dim=1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) < NEAR_TIE * two[:, 0]
    out = {"near_ties": int(near_tie.sum())}
    B_plan, B_tick = N * B_MAIN, (1 + N_REPLAN) * B_MAIN
    for mdl in (model64, model):
        dic = (mdl.q, mdl.v, mdl.A_d, mdl.B_d, mdl.d_d, mdl.dist_w_q,
               mdl.dist_w_v)
        for B, k in ((B_plan, 0), (B_plan - 1, 0), (B_tick, B_MAIN)):
            x = x64[:B].to(mdl.q.dtype)
            tag = f"{str(x.dtype)[6:]} B={B} index_only={k}"
            got = tpwl_select(x, *dic, index_only=k)
            ref = tpwl_select_plain(x, *dic, k)
            torch.cuda.synchronize()
            same = got[0] == ref[0]
            check(bool((same | near_tie[:B]).all()),
                  f"tpwl_select {tag}: {int((~same & ~near_tie[:B]).sum())} "
                  "index differences away from near-ties")
            check(all(a.shape[0] == B - k for a in got[1:]),
                  f"tpwl_select {tag}: {got[1].shape[0]} rows, expected "
                  f"{B - k}")
            err = max([0.0] + [float(e.abs().max()) for e in (
                a[same[k:]] - b[same[k:]] for a, b in zip(got[1:], ref[1:]))
                if e.numel()])
            check(err == 0.0, f"tpwl_select {tag}: gathered rows differ")
            out[tag] = {"index_differences": int((~same).sum()),
                        "max_abs_err": err, "distinct_points": int(
                            torch.unique(got[0]).numel())}
            print(f"[tpwl_select] {tag}: "
                  f"{out[tag]['index_differences']} index differences, all "
                  f"at near-ties (f64 gap < {NEAR_TIE} rel; "
                  f"{int(near_tie[:B].sum())} near-ties), gathered rows "
                  f"bitwise equal, {out[tag]['distinct_points']} distinct "
                  "points")
    dic = (model.q, model.v, model.A_d, model.B_d, model.d_d,
           model.dist_w_q, model.dist_w_v)
    P, r = model.q.shape
    n, mu = model.B_d.shape[1:]
    row = n * n + n * mu + n
    xs = x64.float()
    for name, B, k in (("plan", B_plan, 0), ("tick", B_tick, B_MAIN),
                       ("index_only", B_plan, B_plan)):
        xb = xs[:B]
        n_rows = int(torch.unique(tpwl_select(xb, *dic)[0][k:]).numel())
        ms = cuda_ms(lambda: tpwl_select(xb, *dic, index_only=k), 50)
        clk = clocks()
        plain_ms = cuda_ms(lambda: tpwl_select_plain(xb, *dic, k), 5)
        # states and dictionary coordinates read once, the rows that the
        # states k.. select read once, their rows and every index written
        # once; per state and point 3 operations a coordinate, 2 roots, 3
        # more
        nbytes = 4 * (B * 2 * r + P * 2 * r + n_rows * row
                      + (B - k) * row) + 8 * B
        flops = B * P * (6 * r + 5)
        bound_ms, bound_by = bound(nbytes, flops)
        out[name] = dict(B=B, index_only=k, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                         flops=flops, distinct_rows=n_rows, clocks=clk)
        print(f"[tpwl_select] {name} launch, f32 B={B} index_only={k} "
              f"P={P}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}) [{card}; after it SM clock, max, "
              f"power, temperature: {out[name]['clocks']}]")
    return out


def check_logs(tag, logs, shape_z, shape_u, counts, want):
    """Launch counts as expected, logs finite, of the expected shapes, and
    commands inside the cables' range. Returns (z, u) as numpy."""
    print(f"[{tag}] launches: {counts}")
    for name, n in want.items():
        check(counts[name] == n,
              f"{tag}: {name} launched {counts[name]} times, expected {n}")
    z, u = logs["z"].cpu().numpy(), logs["u"].cpu().numpy()
    check(z.shape == shape_z and u.shape == shape_u,
          f"{tag}: log shapes {z.shape}, {u.shape}")
    check(np.isfinite(z).all() and np.isfinite(u).all(),
          f"{tag}: non-finite logs")
    check(u.min() >= 0.0 and u.max() <= 1500.0,
          f"{tag}: command outside [0, 1500]")
    return z, u


def cpu_agreement(tag, name, got, ref, tol):
    """Difference of a card run's logged z from the f64 CPU run's, relative
    to the CPU run's variation about its mean over time (and batch)."""
    axes = tuple(range(ref.ndim - 1))
    agree = float(np.linalg.norm(got - ref)
                  / np.linalg.norm(ref - ref.mean(axis=axes)))
    print(f"[{tag}] {name} card vs f64 CPU rel z difference {agree:.3e} "
          f"(tol {tol})")
    check(agree <= tol, f"{tag}: {name} card vs CPU difference {agree}")
    return agree


def profile_device(tag, fn, wall_ms):
    """Where the device time of one call of fn() goes, by kernel: printed,
    and returned with the device's busy share of `wall_ms`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    out = dict(device_ms=dev_ms, device_busy_share=dev_ms / wall_ms,
               device_kernel_launches=sum(e.count for e in events),
               top_device_ops=[{"name": e.key[:90],
                                "ms": e.self_device_time_total / 1e3,
                                "calls": e.count} for e in top])
    print(f"[{tag}] device busy {dev_ms:.2f} ms of {wall_ms:.2f} ms per "
          f"run (share {out['device_busy_share']:.3f}) in "
          f"{out['device_kernel_launches']} device operations; top device "
          "time:")
    for e in out["top_device_ops"]:
        print(f"[{tag}]   {e['ms']:8.3f} ms  {e['calls']:5d}x  {e['name']}")
    return out


def phase_fused(tag, mpc, model64, zt, card, want, want_f64, cpu_tol,
                n_timed):
    """A batch-fused loop (build_fused) at B_MAIN for N_WIN windows; `want`
    and `want_f64` are the launches a window of the f32 run and of the f64
    run on the card."""
    path = "condensed" if mpc.formulation == "condensed" else "A"
    run = mpc.build_fused(N_WIN)
    x0 = torch.zeros((B_MAIN, mpc.n_x), dtype=torch.float32,
                     device=mpc.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logs = run(x0, x0, zt)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    T = N_WIN * N_REPLAN
    z, _ = check_logs(tag, logs, (B_MAIN, T, mpc.n_z), (B_MAIN, T, mpc.n_u),
                      counts, {k: v * N_WIN for k, v in want.items()})
    track = rel_track(z, zt)
    print(f"[{tag}] rel tracking error {track:.5f} (gate {QUALITY_GATE}); "
          f"peak device memory {peak_gb:.2f} GB")
    check(track <= QUALITY_GATE, f"{tag}: rel tracking error {track}")

    # host clock around whole runs: the spread is kept beside the median
    runs_ms = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(x0, x0, zt)
        torch.cuda.synchronize()
        runs_ms.append(1e3 * (time.perf_counter() - t0))
    t_run = float(np.median(runs_ms)) / 1e3
    windows_per_s = B_MAIN * N_WIN / t_run
    print(f"[{tag}] {windows_per_s:.1f} windows/s (median of {n_timed} "
          f"runs: {1e3 * t_run:.2f} ms per {N_WIN}-window run at "
          f"B={B_MAIN}, f32; min {min(runs_ms):.2f}, max "
          f"{max(runs_ms):.2f} ms) [{card}]")
    out = dict(launches=counts, rel_track=track, peak_memory_gb=peak_gb,
               windows_per_s=windows_per_s, run_ms=1e3 * t_run,
               runs_ms=runs_ms)

    # where the time of one run goes: device time by kernel
    out.update(profile_device(tag, lambda: run(x0, x0, zt), 1e3 * t_run))

    # the same loop at B=8, in f32 and in f64 on the card, against the
    # port's f64 run on the CPU
    cpu_mpc = make_mpc(model64.to(device="cpu"), torch.float64, "cpu", path)
    x0c = np.zeros((B_CPU, mpc.n_x))
    ref = cpu_mpc.build_fused(N_WIN)(x0c, x0c, zt[:B_CPU])["z"].numpy()
    run64 = make_mpc(model64, torch.float64, mpc.device,
                     path).build_fused(N_WIN)
    for name, fn, tol in (("f32", run, cpu_tol),
                          ("f64", run64, F64_CPU_AGREE_TOL)):
        reset_counts()
        got = fn(x0c, x0c, zt[:B_CPU])["z"].cpu().numpy()
        counts = read_counts()
        out[f"cpu_rel_diff_{name}"] = cpu_agreement(
            tag, f"B={B_CPU} {name}", got, ref, tol)
        if name == "f64":
            print(f"[{tag}] f64 B={B_CPU} launches: {counts}")
            for k, v in want_f64.items():
                check(counts[k] == v * N_WIN, f"{tag} f64: {k} launched "
                      f"{counts[k]} times, expected {v * N_WIN}")
            out["launches_f64"] = counts
    return out


def phase_single_loop(mpc, model64, zt1, card):
    """Path B: the single-trajectory loop (build) for N_WIN_B windows."""
    run = mpc.build(N_WIN_B)
    x0 = torch.zeros(mpc.n_x, dtype=torch.float32, device=mpc.device)
    reset_counts()
    logs = run(x0, x0, zt1)
    torch.cuda.synchronize()
    counts = read_counts()
    T = N_WIN_B * N_REPLAN
    z, _ = check_logs("path B", logs, (T, mpc.n_z), (T, mpc.n_u), counts,
                      {"admm_single": N_WIN_B, "admm_stream": 0,
                       "admm_cluster": 0, "admm_batched": 0,
                       "tpwl_select": (1 + N_REPLAN) * N_WIN_B})
    track = rel_track(z[None], zt1[None])
    runs_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(x0, x0, zt1)
        torch.cuda.synchronize()
        runs_ms.append(1e3 * (time.perf_counter() - t0))
    ms_win = float(np.median(runs_ms)) / N_WIN_B
    print(f"[path B] {ms_win:.3f} ms per window (host clock, median of 5 "
          f"runs of {N_WIN_B} windows, f32; runs {min(runs_ms):.2f} to "
          f"{max(runs_ms):.2f} ms); rel tracking error {track:.5f} (not "
          f"gated: R = 1e-3 I trades tracking for effort) [{card}]")
    cpu_mpc = make_mpc(model64.to(device="cpu"), torch.float64, "cpu", "B")
    x0c = np.zeros(mpc.n_x)
    ref = cpu_mpc.build(N_WIN_B)(x0c, x0c, zt1)["z"].numpy()
    z64 = make_mpc(model64, torch.float64, mpc.device, "B").build(N_WIN_B)(
        x0c, x0c, zt1)["z"].cpu().numpy()
    out = dict(launches=counts, ms_per_window=ms_win, runs_ms=runs_ms,
               rel_track=track)
    # where the time of one run goes (printed only; the loop is host-bound)
    out.update(profile_device("path B", lambda: run(x0, x0, zt1),
                              float(np.median(runs_ms))))
    for name, got, tol in (("f32", z, PATH_B_CPU_AGREE_TOL),
                           ("f64", z64, F64_CPU_AGREE_TOL)):
        out[f"cpu_rel_diff_{name}"] = cpu_agreement("path B", name, got,
                                                    ref, tol)
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
    mpc_a = make_mpc(model, torch.float32, dev, "A")
    mpc_b = make_mpc(model, torch.float32, dev, "B")
    zt = feasible_targets(model, B_MAIN, N_WIN)
    zt_b = feasible_targets(model, 1, N_WIN_B)[0]

    # states near the dictionary: its points plus seeded noise
    rng = np.random.default_rng(3)
    X_pts = torch.cat([model64.v, model64.q], dim=1)
    pts = torch.as_tensor(rng.integers(0, model.num_points, N * B_MAIN),
                          device=dev)
    noise = torch.as_tensor(rng.normal(size=(N * B_MAIN, model.state_dim)),
                            device=dev)
    x_near = X_pts[pts] + 0.05 * X_pts.std(dim=0) * noise

    # 3.-6. every kernel against its plain version
    rec["admm_batched"] = phase_admm(
        admm_batched, make_mpc(model64, torch.float64, dev), mpc, x_near, zt,
        card, (B_MAIN, 1, 3), ADMM_F32_TOL, 50, other_size=(100, 120))
    rec["tpwl_select"] = phase_select(model64, model, x_near, card)
    rec["admm_stream"] = phase_admm(
        admm_stream, make_mpc(model64, torch.float64, dev, "A"), mpc_a,
        x_near, zt, card, (64, 1, 3), SPARSE_F32_TOL, 5)
    rec["admm_cluster"] = phase_admm(
        admm_cluster, make_mpc(model64, torch.float64, dev, "A",
                               horizon=N_F64_CLUSTER), mpc_a,
        x_near, zt, card, (64, 1, 3), SPARSE_F32_TOL, 5,
        cluster_sizes=(6, 8))
    rec["admm_single"] = phase_single(
        make_mpc(model64, torch.float64, dev, "B"), mpc_b, x_near, zt, card)
    torch.cuda.empty_cache()

    # 7.-9. the paths
    none = {"tpwl_select": 1 + N_REPLAN, "admm_batched": 0,
            "admm_cluster": 0, "admm_stream": 0, "admm_single": 0}
    small = {**none, "admm_batched": 4}
    rec["condensed"] = phase_fused("condensed", mpc, model64, zt, card,
                                   small, small, CPU_AGREE_TOL, 10)
    rec["path_a"] = phase_fused(
        "path A", mpc_a, model64, zt, card, {**none, "admm_cluster": 4},
        {**none, "admm_stream": 4}, PATH_A_CPU_AGREE_TOL, 5)
    rec["path_b"] = phase_single_loop(mpc_b, model64, zt_b, card)

    k2 = rec["tpwl_select"]["plan"]
    paths = {"condensed": rec["condensed"]["launches"],
             "path_a": rec["path_a"]["launches"],
             "path_a_f64": rec["path_a"]["launches_f64"],
             "path_b": rec["path_b"]["launches"]}
    src = "soft_robot_control_tpu_torch/csrc/"
    ref = "soft_robot_control_tpu/ops/"

    def entry(name, replaces, path, err, k):
        """One kernel's record; `launches` is the count on the path that
        the kernel carries, `launches_by_path` the count on each."""
        return {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
                "replaces": ref + replaces, "launches": paths[path][name],
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None}

    # library_ms: no single PyTorch call computes a fixed-iteration ADMM
    # or a select-then-gather. tpwl_select's max_abs_err is over the
    # gathered rows where the indices agree; phase 4 fails on any index
    # difference that is not a near-tie
    kernels = [
        entry("admm_batched", "pallas_admm.py:132", "condensed",
              rec["admm_batched"][f"float32 B={B_MAIN}"]["max_abs_err"],
              rec["admm_batched"]),
        entry("tpwl_select", "pallas_tpwl.py:24", "condensed",
              rec["tpwl_select"][f"float32 B={N * B_MAIN} index_only=0"][
                  "max_abs_err"], k2),
        entry("admm_stream", "pallas_admm.py:94", "path_a_f64",
              rec["admm_stream"]["float32 B=64"]["max_abs_err"],
              rec["admm_stream"]),
        entry("admm_cluster", "pallas_admm.py:94", "path_a",
              rec["admm_cluster"]["float32 B=64"]["max_abs_err"],
              rec["admm_cluster"]),
        entry("admm_single", "pallas_admm.py:28", "path_b",
              rec["admm_single"]["float32"]["max_abs_err"],
              rec["admm_single"]),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
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
