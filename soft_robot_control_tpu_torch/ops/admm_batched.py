"""Batched fixed-iteration ADMM: B independent QPs in one kernel launch.

Port of the TPU kernels soft_robot_control_tpu/ops/pallas_admm.py
_admm_chunk_kernel and _admm_kinv_kernel (entry admm_batched_pallas) as
three hand-written CUDA kernels that compute the same function:

- csrc/admm_batched.cu, for QPs that fit a block's shared memory, in two
  forms chosen by a rule on (n, m, element size) (`batched_form`): in
  float32 for n <= 32, m <= 64 (the condensed LOCP, n=20, m=40) one warp
  per QP with A, A^T and K^-1 in registers; otherwise one block per QP
  with K^-1 and A resident in shared memory and each mat-vec split over
  the block's threads (A^T t in row groups; threads and groups from
  `block_layout`, from B, n, m and the element size). Both are bound by the latency of the per-iteration
  chain of small mat-vecs.
- csrc/admm_cluster.cu, one thread-block cluster per QP with K^-1 and A
  resident across the cluster's shared memory, each block owning a slice of
  rows, for QPs that fit a cluster but not a block (the sparse LOCP, n=380,
  m=400, in f32). Device memory is read once; the iterations run on shared
  memory and two cluster exchanges each.
- csrc/admm_stream.cu, the same cluster iteration on 8 blocks for QPs that
  fit no cluster (GuSTO's sparse LOCP, n=386, m=1126; the sparse LOCP in
  f64): each block keeps as many leading rows of its slices in shared memory
  as fit, rows of A first, and walks the rest in place through L2
  (`cluster_plan(..., stream=True)`). It is bound by those walks and the
  chain of phases. Its vectors alone must fit a block: with full-length
  slots for the peers' x~ partials about 15.75 n elements at n = m; past
  that (n = m beyond 1,842 in float64, 3,684 in float32) it receives x~ in
  windows and gathers it, about 8.75 n, up to n = m = 3,312 in float64 and
  6,624 in float32; larger QPs raise.

`admm_batched` picks among them from the QP's size and element type alone
(`kernel_for` is the same rule in Python, `cluster_plan` the layout of a QP
over a cluster); `admm_cluster` and `admm_stream` are the second and third
kernel's own wrappers. All launch their kernel for CUDA tensors (float32 or
float64) and run `admm_batched_plain`, the same arithmetic in PyTorch, only
for CPU tensors. `admm_batched.launches`, `admm_cluster.launches` and
`admm_stream.launches` count the launches of the three kernels; each launch
is the span `qp.admm` (utils/timing.py).
"""

from __future__ import annotations

import ctypes

import torch

from soft_robot_control_tpu_torch.ops import build
from soft_robot_control_tpu_torch.utils.timing import span

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_MAX_CLUSTER = 8      # blocks of the largest portable cluster
_MAX_THREADS = 1024   # threads a block
_SMS = 132            # streaming multiprocessors of an H100 SXM
_LAUNCH_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                + [ctypes.c_double] * 2 + [ctypes.c_void_p])
_CLUSTER_ARGS = _LAUNCH_ARGS[:-1] + [ctypes.c_int, ctypes.c_void_p]
_PLAN_ARGS = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
_SIGNATURES = {
    "admm_batched": {
        "admm_batched_qp_bytes": (ctypes.c_size_t, [ctypes.c_int] * 3),
        "admm_batched_form": (ctypes.c_int, [ctypes.c_int] * 3),
        "admm_batched_block_layout": (None, [ctypes.c_int] * 4
                                      + [ctypes.POINTER(ctypes.c_int)]),
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
        "admm_stream_plan": (ctypes.c_int, _PLAN_ARGS),
        "admm_stream_max_active": (ctypes.c_int, [ctypes.c_int] * 3),
        "admm_stream_f32": (ctypes.c_int, _LAUNCH_ARGS),
        "admm_stream_f64": (ctypes.c_int, _LAUNCH_ARGS),
    },
}
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
PLAN_FIELDS = ("R", "V", "a_rows", "k_rows", "resident", "block_bytes",
               "a_res", "k_res", "x_window")


def qp_bytes(n: int, m: int, elem_size: int) -> int:
    """Shared memory one QP takes in csrc/admm_batched.cu's block form
    without its partials (qp_bytes): K^-1 and rhs in float64, then x~, A
    with an odd row stride, 2 more n-vectors and 6 m-vectors in the QP's
    type; rhs and x~ padded to whole 16 bytes."""
    def up16(x, e):
        return -(-x * e // 16) * 16 // e
    return ((up16(n * n, 8) + up16(n, 8)) * 8
            + (up16(n, elem_size) + m * (n | 1) + 2 * n + 6 * m) * elem_size)


def batched_form(n: int, m: int, elem_size: int) -> str:
    """The form csrc/admm_batched.cu (admm_batched_form) takes for a QP of
    this size and element size that fits a block: 'registers' (matrices in
    a warp's registers) in float32 for n <= 32 and m <= 64, 'block' (a
    block a QP, matrices in shared memory) otherwise."""
    if elem_size == 4 and n <= 32 and m <= 64:
        return "registers"
    return "block"


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def block_layout(B: int, n: int, m: int, elem_size: int) -> dict:
    """The block form's launch in csrc/admm_batched.cu (block_threads,
    block_groups, block_bytes): threads a block, enough for a row of A each
    and for n columns in about sqrt(m) row groups, a multiple of 32 in
    [64, 1024], and at most 1024 over the blocks an SM holds at once (B /
    132, or fewer where their shared memory is the limit); G row groups of
    A^T t, as many as the threads hold, at most m, as the shared memory
    beside the QP allows; the bytes of shared memory a block."""
    groups = 1
    while groups * groups < m:
        groups += 1
    t = -(-max(n * groups, m) // 32) * 32
    qp = qp_bytes(n, m, elem_size)
    fit = _SMEM_LIMIT // qp if qp < _SMEM_LIMIT else 1
    per_sm = min(-(-B // _SMS) if B > _SMS else 1, fit)
    t = min(max(min(t, (_MAX_THREADS // per_sm) & ~31), 64), _MAX_THREADS)
    room = max(_SMEM_LIMIT - qp, 0)
    G = max(min(t // n, m, room // (n * elem_size)), 1)
    return dict(threads=t, groups=G,
                block_bytes=qp + (G * n * elem_size if G > 1 else 0))


def row_slices(rows: int, R: int):
    """[lo, hi) of the `rows` rows that each of R blocks owns: contiguous,
    ceil(rows / R) each, the last ones fewer or none."""
    per = _ceil_div(rows, R)
    return [(min(r * per, rows), min(r * per + per, rows)) for r in range(R)]


def rhs_window(n: int, R: int, rank: int, elem_size: int):
    """The window [lo, hi) of a peer's A^T t partial that block `rank` of
    a cluster receives (csrc/admm_cluster.cuh rhs_window): its rows of
    K^-1, widened to 16-byte boundaries for the bulk copy."""
    W = 16 // elem_size
    lo, hi = row_slices(n, R)[rank]
    return lo // W * W, _ceil_div(hi, W) * W


def usable_cluster(n: int, R: int) -> int:
    """The largest cluster of at most R blocks in which every block owns a
    row of the n rows of K^-1 (the kernels' exchange relies on it)."""
    while R > 1 and (R - 1) * _ceil_div(n, R) >= n:
        R -= 1
    return R


def cluster_plan(n: int, m: int, elem_size: int, R: int | None = None,
                 single: bool = False, stream: bool = False):
    """How csrc/admm_cluster.cuh (make_plan) lays a QP of n variables and m
    rows over a thread-block cluster, or None where it does not fit.

    At most R blocks a cluster (fewer where a block would own no row of
    K^-1): as given, else the smallest of 1..8 that holds the QP; the
    single-QP kernel (`single`, M1 form) always asks for 8 and walks the
    matrices in place (`resident` False) where they do not fit; the
    streaming kernel (`stream`) asks for 8 and keeps as many leading rows
    of a block's slices as fit, rows of A first, and, where R slots of
    full x~ partials leave its vectors no room, receives x~ in windows
    (`x_window`: each block sums the windows around its rows of the
    peers' x~ partials and gathers the finished rows to every peer). The
    dict holds R, V
    (elements a 16-byte load, 1 for ragged rows), a_rows and k_rows (rows
    of A and of K^-1 or M1 a block owns at most), resident (all of them in
    shared memory), block_bytes (shared memory a block: two barriers,
    three with x_window, the resident rows (for `stream` each padded with zeros to n rounded up to
    16 bytes; the region padded to 16 bytes), q, w, rhs, x~ and the
    block's own two partials (n rounded up to 16 bytes each), R slots for
    the peers' partials of x~ (rhs_slot each with x_window) and R of
    A^T t, six vectors of the block's rows and, for M1, s), x_window,
    a_res and k_res (the leading rows of a block's slices of A and of K^-1
    or M1 kept in shared memory), rhs_slot (elements of a slot of A^T t
    partials: a window of `rhs_window`, or all n for M1), and a_slices,
    k_slices (each block's [lo, hi))."""
    W = 16 // elem_size
    V = W if n % W == 0 else 1

    def up16(x):
        return _ceil_div(x, W) * W

    def plan(R, residency):
        R = usable_cluster(n, R)
        mr, nr = _ceil_div(m, R), _ceil_div(n, R)
        slot = up16(n) if single else up16(nr + 2 * (W - 1))
        rest = 6 * mr + (nr if single else 0)
        vec = (6 + R) * up16(n) + R * slot + rest
        bar = 16
        x_window = (residency == "some"
                    and vec > (_SMEM_LIMIT - bar) // elem_size)
        if x_window:
            bar = 32
            vec = 6 * up16(n) + 2 * R * slot + rest
        room = (_SMEM_LIMIT - bar) // elem_size
        if vec > room:
            return None
        rows = {"all": mr + nr, "none": 0}.get(residency,
                                              (room - vec) // up16(n))
        ra = min(rows, mr)
        rk = min(rows - ra, nr)
        sld = up16(n) if residency == "some" else n
        nbytes = bar + (up16((ra + rk) * sld) + vec) * elem_size
        if nbytes > _SMEM_LIMIT:
            return None
        return dict(R=R, V=V, a_rows=mr, k_rows=nr,
                    resident=ra == mr and rk == nr, block_bytes=nbytes,
                    a_res=ra, k_res=rk, x_window=x_window, rhs_slot=slot,
                    a_slices=row_slices(m, R), k_slices=row_slices(n, R))

    if single:
        return plan(_MAX_CLUSTER, "all") or plan(_MAX_CLUSTER, "none")
    if stream:
        return plan(_MAX_CLUSTER, "some")
    if R is not None:
        return plan(R, "all") if 1 <= R <= _MAX_CLUSTER else None
    return next((p for p in (plan(R, "all") for R in range(
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
    with span("qp.admm"):
        w = torch.empty((B, n), dtype=dt, device=Kinv.device)
        y = torch.empty((B, m), dtype=dt, device=Kinv.device)
        stream = torch.cuda.current_stream(Kinv.device).cuda_stream
        rc = getattr(lib, name + _SUFFIX[dt])(
            *[t.data_ptr() for t in args], w.data_ptr(), y.data_ptr(),
            B, n, m, int(iters), float(sigma), float(alpha), *extra, stream)
        if rc == -1:
            raise ValueError(f"{name}: a QP with n={n}, m={m} needs more "
                             f"shared memory than the kernel has "
                             f"({_SMEM_LIMIT} bytes a block)")
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        wrapper.launches += 1
        return w, y


def admm_stream(Kinv, A, q, l, u, rho_vec, w0, y0, iters: int,
                sigma: float = 1e-6, alpha: float = 1.6):
    """B fixed-iteration ADMM solves through the streaming kernel, a cluster
    of 8 blocks a QP with what does not fit their shared memory walked in
    place, whatever the QP's size up to vectors that fit (n = m up to 3,312
    in float64, 6,624 in float32; see admm_batched_plain for the shapes).
    CPU tensors go through the plain version."""
    if Kinv.device.type == "cpu":
        return admm_batched_plain(Kinv, A, q, l, u, rho_vec, w0, y0, iters,
                                  sigma, alpha)
    args = _checked("admm_stream", Kinv, A, q, l, u, rho_vec, w0, y0)
    return _launch(admm_stream, _stream_lib(), args, iters, sigma, alpha)


def exported_plan(out) -> dict:
    """The integers a .cu source's export_plan wrote, as cluster_plan's
    dict (without rhs_slot and the slices)."""
    plan = dict(zip(PLAN_FIELDS, out))
    plan.update(resident=bool(plan["resident"]),
                x_window=bool(plan["x_window"]))
    return plan


def _cluster_lib():
    return build.load("admm_cluster", _SIGNATURES["admm_cluster"])


def _stream_lib():
    return build.load("admm_stream", _SIGNATURES["admm_stream"])


def stream_plan_built(n: int, m: int, elem_size: int):
    """The streaming kernel's plan as the built csrc/admm_stream.cu exports
    it (PLAN_FIELDS), or None where not even its vectors fit. Needs the
    CUDA toolkit."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    if _stream_lib().admm_stream_plan(n, m, elem_size, out) != 0:
        return None
    return exported_plan(out)


def stream_max_active(n: int, m: int, elem_size: int) -> int:
    """Clusters (QPs) of the streaming kernel the card holds at one time."""
    rc = _stream_lib().admm_stream_max_active(n, m, elem_size)
    if rc < 0:
        raise RuntimeError(f"admm_stream_max_active(n={n}, m={m}) failed: "
                           f"{rc}")
    return rc


def batched_form_built(n: int, m: int, elem_size: int) -> str:
    """The form the built csrc/admm_batched.cu gives that QP."""
    lib = build.load("admm_batched", _SIGNATURES["admm_batched"])
    return ("block", "registers")[lib.admm_batched_form(n, m, elem_size)]


def block_layout_built(B: int, n: int, m: int, elem_size: int) -> dict:
    """The block form's layout as the built csrc/admm_batched.cu exports
    it (block_layout's dict)."""
    lib = build.load("admm_batched", _SIGNATURES["admm_batched"])
    out = (ctypes.c_int * 3)()
    lib.admm_batched_block_layout(B, n, m, elem_size, out)
    return dict(zip(("threads", "groups", "block_bytes"), out))


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
    shapes). CUDA tensors go through csrc/admm_batched.cu when one QP fits
    a block's shared memory, in the form its rule gives the QP, through
    the cluster-resident kernel when it fits a cluster's, and through the
    streaming kernel beyond, by the byte counts that the kernels' sources
    export; CPU tensors go through the plain version."""
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
