"""Batched fixed-iteration ADMM: B independent QPs in one kernel launch.

Port of the TPU kernels soft_robot_control_tpu/ops/pallas_admm.py
_admm_chunk_kernel and _admm_kinv_kernel (entry admm_batched_pallas) as
three hand-written CUDA kernels that compute the same function:

- csrc/admm_batched.cu, for QPs that fit a block's shared memory, in two
  forms chosen by size and element type (`batched_form`): in float32 for
  n <= 32, m <= 64 (the condensed LOCP, n=20, m=40) one warp per QP with
  A, A^T and K^-1 in registers, each mat-vec a chain of FMAs on a lane's
  own registers against a vector broadcast from shared memory; otherwise
  one warp per QP with K^-1 and A resident in shared memory. Both are bound
  by the latency of the per-iteration chain of small mat-vecs.
- csrc/admm_cluster.cu, one thread-block cluster per QP with K^-1 and A
  resident across the cluster's shared memory, each block owning a slice of
  rows, for QPs that fit a cluster but not a block (the sparse LOCP, n=380,
  m=400, in f32). Device memory is read once; the iterations run on shared
  memory and two cluster barriers each.
- csrc/admm_stream.cu, one block per QP with K^-1 and A streamed from
  device memory every iteration, for QPs that fit neither (the sparse LOCP
  in f64). It is bound by bytes.

`admm_batched` picks among them from the QP's size and element type alone
(`kernel_for` is the same rule in Python, `cluster_plan` the layout of a QP
over a cluster); `admm_cluster` and `admm_stream` are the second and third
kernel's own wrappers. All launch their kernel for CUDA tensors (float32 or
float64) and run `admm_batched_plain`, the same arithmetic in PyTorch, only
for CPU tensors. `admm_batched.launches`, `admm_cluster.launches` and
`admm_stream.launches` count the launches of the three kernels.
"""

from __future__ import annotations

import ctypes

import torch

from soft_robot_control_tpu_torch.ops import build

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_MAX_CLUSTER = 8      # blocks of the largest portable cluster
_LAUNCH_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                + [ctypes.c_double] * 2 + [ctypes.c_void_p])
_CLUSTER_ARGS = _LAUNCH_ARGS[:-1] + [ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "admm_batched": {
        "admm_batched_qp_bytes": (ctypes.c_size_t, [ctypes.c_int] * 3),
        "admm_batched_form": (ctypes.c_int, [ctypes.c_int] * 3),
        "admm_batched_f32": (ctypes.c_int, _LAUNCH_ARGS),
        "admm_batched_f64": (ctypes.c_int, _LAUNCH_ARGS),
    },
    "admm_cluster": {
        "admm_cluster_plan": (ctypes.c_int, [ctypes.c_int] * 4
                              + [ctypes.POINTER(ctypes.c_int)]),
        "admm_cluster_max_active": (ctypes.c_int, [ctypes.c_int] * 4),
        "admm_cluster_f32": (ctypes.c_int, _CLUSTER_ARGS),
        "admm_cluster_f64": (ctypes.c_int, _CLUSTER_ARGS),
    },
    "admm_stream": {
        "admm_stream_f32": (ctypes.c_int, _LAUNCH_ARGS),
        "admm_stream_f64": (ctypes.c_int, _LAUNCH_ARGS),
    },
}
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
PLAN_FIELDS = ("R", "V", "a_rows", "k_rows", "resident", "bulk",
               "block_bytes")


def qp_bytes(n: int, m: int, elem_size: int) -> int:
    """Shared memory one QP takes in csrc/admm_batched.cu (qp_elems): K^-1,
    A with an odd row stride, 4 n-vectors and 6 m-vectors."""
    return (n * n + m * (n | 1) + 4 * n + 6 * m) * elem_size


def batched_form(n: int, m: int, elem_size: int) -> str:
    """The form csrc/admm_batched.cu (admm_batched_form) takes for a QP of
    this size and element size: 'registers' (matrices in a warp's
    registers) in float32 for n <= 32 and m <= 64, 'shared' (matrices in
    shared memory) otherwise."""
    return ("registers" if elem_size == 4 and n <= 32 and m <= 64
            else "shared")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def row_slices(rows: int, R: int):
    """[lo, hi) of the `rows` rows that each of R blocks owns: contiguous,
    ceil(rows / R) each, the last ones fewer or none."""
    per = _ceil_div(rows, R)
    return [(min(r * per, rows), min(r * per + per, rows)) for r in range(R)]


def usable_cluster(n: int, R: int) -> int:
    """The largest cluster of at most R blocks in which every block owns a
    row of the n rows of K^-1 (the kernels' exchange relies on it)."""
    while R > 1 and (R - 1) * _ceil_div(n, R) >= n:
        R -= 1
    return R


def cluster_plan(n: int, m: int, elem_size: int, R: int | None = None,
                 single: bool = False):
    """How csrc/admm_cluster.cuh (make_plan) lays a QP of n variables and m
    rows over a thread-block cluster, or None where it does not fit.

    At most R blocks a cluster (fewer where a block would own no row of
    K^-1): as given, else the smallest of 1..8 that holds the QP; the
    single-QP kernel (`single`, M1 form) always asks for 8 and walks the
    matrices in place (`resident` False) where they do not fit. The dict
    holds R, V (elements a 16-byte load, 1 for ragged rows), a_rows and
    k_rows (rows of A and of K^-1 or M1 a block owns at most), resident,
    bulk (partials travel as bulk copies, which need every piece on 16-byte
    ends, else element by element), block_bytes (shared memory a block: two
    barriers, the slices, q, w, rhs, x~, the block's own two partials, R
    slots for the peers' partials of x~ and of rhs, six vectors of the
    block's rows and, for M1, s), and a_slices, k_slices (each block's
    [lo, hi))."""
    V = 16 // elem_size if n % (16 // elem_size) == 0 else 1

    def plan(R, resident):
        R = usable_cluster(n, R)
        mr, nr = _ceil_div(m, R), _ceil_div(n, R)
        rhs_slots = -(-R * (n if single else nr) // 4) * 4
        elems = ((mr + nr) * n if resident else 0) + (6 + R) * n + (
            rhs_slots + 6 * mr + (nr if single else 0))
        nbytes = 16 + elems * elem_size
        if nbytes > _SMEM_LIMIT:
            return None
        return dict(R=R, V=V, a_rows=mr, k_rows=nr, resident=resident,
                    bulk=V * elem_size == 16 and nr % V == 0,
                    block_bytes=nbytes, a_slices=row_slices(m, R),
                    k_slices=row_slices(n, R))

    if single:
        return plan(_MAX_CLUSTER, True) or plan(_MAX_CLUSTER, False)
    if R is not None:
        return plan(R, True) if 1 <= R <= _MAX_CLUSTER else None
    return next((p for p in (plan(R, True) for R in range(
        1, _MAX_CLUSTER + 1)) if p), None)


def kernel_for(n: int, m: int, elem_size: int) -> str:
    """The kernel `admm_batched` launches for a QP of this size and element
    size: 'admm_batched' where it fits a block's shared memory,
    'admm_cluster' where it fits a cluster's, 'admm_stream' beyond."""
    if qp_bytes(n, m, elem_size) <= _SMEM_LIMIT:
        return "admm_batched"
    if cluster_plan(n, m, elem_size) is not None:
        return "admm_cluster"
    return "admm_stream"


def admm_batched_plain(Kinv, A, q, l, u, rho_vec, w0, y0, iters: int,
                       sigma: float = 1e-6, alpha: float = 1.6):
    """The kernels' function in PyTorch. Kinv (B,n,n) symmetric, A (B,m,n),
    q, w0 (B,n), l, u, y0 (B,m), rho_vec (m,) shared (a (B,m) rho works
    here too). Bounds may be infinite. Returns (w, y)."""
    w, y = w0, y0
    z = torch.clamp(torch.einsum("bmn,bn->bm", A, w), l, u)
    for _ in range(int(iters)):
        rhs = sigma * w - q + torch.einsum("bmn,bm->bn", A, rho_vec * z - y)
        x_t = torch.einsum("bij,bj->bi", Kinv, rhs)
        z_t = torch.einsum("bmn,bn->bm", A, x_t)
        w = alpha * x_t + (1 - alpha) * w
        z_rel = alpha * z_t + (1 - alpha) * z
        z_new = torch.clamp(z_rel + y / rho_vec, l, u)
        y = y + rho_vec * (z_rel - z_new)
        z = z_new
    return w, y


def _checked(name, Kinv, A, q, l, u, rho_vec, w0, y0):
    """The kernel's inputs, contiguous, after checking device, dtype and
    shapes; raises on what the kernels do not take."""
    if Kinv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {Kinv.device}")
    B, n = q.shape
    m = A.shape[1]
    dt = Kinv.dtype
    if dt not in _SUFFIX:
        raise TypeError(f"{name} kernel takes float32 or float64, got {dt}")
    args = [Kinv, A, q, l, u, rho_vec, w0, y0]
    shapes = [(B, n, n), (B, m, n), (B, n), (B, m), (B, m), (m,), (B, n),
              (B, m)]
    for t, s in zip(args, shapes):
        if t.device != Kinv.device or t.dtype != dt or tuple(t.shape) != s:
            raise ValueError(f"{name}: expected {dt} {s} on {Kinv.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return [t.contiguous() for t in args]


def _launch(wrapper, lib, args, iters, sigma, alpha, *extra):
    """Launch `wrapper`'s kernel from `lib` on checked args; counts it.
    `extra` are the kernel's own integer arguments before the stream."""
    name = wrapper.__name__
    Kinv, A = args[0], args[1]
    B, n, m, dt = Kinv.shape[0], Kinv.shape[1], A.shape[1], Kinv.dtype
    w = torch.empty((B, n), dtype=dt, device=Kinv.device)
    y = torch.empty((B, m), dtype=dt, device=Kinv.device)
    stream = torch.cuda.current_stream(Kinv.device).cuda_stream
    rc = getattr(lib, name + _SUFFIX[dt])(
        *[t.data_ptr() for t in args], w.data_ptr(), y.data_ptr(),
        B, n, m, int(iters), float(sigma), float(alpha), *extra, stream)
    if rc == -1:
        raise ValueError(f"{name}: a QP with n={n}, m={m} needs more shared "
                         f"memory than the kernel has ({_SMEM_LIMIT} bytes a "
                         "block)")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return w, y


def admm_stream(Kinv, A, q, l, u, rho_vec, w0, y0, iters: int,
                sigma: float = 1e-6, alpha: float = 1.6):
    """B fixed-iteration ADMM solves through the streaming kernel, whatever
    the QP's size (see admm_batched_plain for the shapes). CPU tensors go
    through the plain version."""
    if Kinv.device.type == "cpu":
        return admm_batched_plain(Kinv, A, q, l, u, rho_vec, w0, y0, iters,
                                  sigma, alpha)
    args = _checked("admm_stream", Kinv, A, q, l, u, rho_vec, w0, y0)
    lib = build.load("admm_stream", _SIGNATURES["admm_stream"])
    return _launch(admm_stream, lib, args, iters, sigma, alpha)


def exported_plan(out) -> dict:
    """The integers a .cu source's export_plan wrote, as cluster_plan's
    dict (without the slices)."""
    plan = dict(zip(PLAN_FIELDS, out))
    plan.update(resident=bool(plan["resident"]), bulk=bool(plan["bulk"]))
    return plan


def _cluster_lib():
    return build.load("admm_cluster", _SIGNATURES["admm_cluster"])


def cluster_plan_built(n: int, m: int, elem_size: int, R: int = 0):
    """The plan as the built csrc/admm_cluster.cu exports it (PLAN_FIELDS),
    or None where the QP fits no cluster; R = 0 asks for the smallest
    cluster. Needs the CUDA toolkit."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    if _cluster_lib().admm_cluster_plan(n, m, elem_size, R, out) != 0:
        return None
    return exported_plan(out)


def cluster_max_active(n: int, m: int, elem_size: int, R: int = 0) -> int:
    """Clusters of that plan the card holds at one time
    (cudaOccupancyMaxActiveClusters): the QPs in flight."""
    rc = _cluster_lib().admm_cluster_max_active(n, m, elem_size, R)
    if rc < 0:
        raise RuntimeError(f"admm_cluster_max_active(n={n}, m={m}, R={R}) "
                           f"failed: {rc}")
    return rc


def admm_cluster(Kinv, A, q, l, u, rho_vec, w0, y0, iters: int,
                 sigma: float = 1e-6, alpha: float = 1.6,
                 cluster_size: int | None = None):
    """B fixed-iteration ADMM solves through the cluster-resident kernel
    (see admm_batched_plain for the shapes): any QP that fits the shared
    memory of a cluster of at most `cluster_size` blocks, by default the
    smallest cluster that holds it; raises where it fits none. CPU tensors go
    through the plain version."""
    if Kinv.device.type == "cpu":
        return admm_batched_plain(Kinv, A, q, l, u, rho_vec, w0, y0, iters,
                                  sigma, alpha)
    args = _checked("admm_cluster", Kinv, A, q, l, u, rho_vec, w0, y0)
    return _launch(admm_cluster, _cluster_lib(), args, iters, sigma, alpha,
                   int(cluster_size or 0))


def admm_batched(Kinv, A, q, l, u, rho_vec, w0, y0, iters: int,
                 sigma: float = 1e-6, alpha: float = 1.6):
    """B fixed-iteration ADMM solves (see admm_batched_plain for the
    shapes). CUDA tensors go through the warp-per-QP kernel when one QP
    fits a block's shared memory, through the cluster-resident kernel when
    it fits a cluster's, and through the streaming kernel beyond, by the
    byte counts that the kernels' sources export; CPU tensors go through
    the plain version."""
    if Kinv.device.type == "cpu":
        return admm_batched_plain(Kinv, A, q, l, u, rho_vec, w0, y0, iters,
                                  sigma, alpha)
    args = _checked("admm_batched", Kinv, A, q, l, u, rho_vec, w0, y0)
    lib = build.load("admm_batched", _SIGNATURES["admm_batched"])
    n, m, elem = q.shape[1], A.shape[1], Kinv.element_size()
    if lib.admm_batched_qp_bytes(n, m, elem) <= _SMEM_LIMIT:
        return _launch(admm_batched, lib, args, iters, sigma, alpha)
    if cluster_plan_built(n, m, elem) is not None:
        return admm_cluster(*args, iters, sigma, alpha)
    return admm_stream(*args, iters, sigma, alpha)


admm_batched.launches = 0
admm_cluster.launches = 0
admm_stream.launches = 0
