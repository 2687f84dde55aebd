"""TPWL nearest-point select and gather for a batch of states.

Port of the TPU kernel soft_robot_control_tpu/ops/pallas_tpwl.py
(_select_kernel, entry tpwl_gather_pallas) as the hand-written CUDA kernel
csrc/tpwl_select.cu. It computes the distances by direct differences, the
form of TPWLModel.point_distances, not the Pallas kernel's squared-norm
expansion. On an H100 it is bound by the bytes of the gathered rows; the
source says how the design keeps everything else out of device memory.

`tpwl_select` launches the kernel for CUDA tensors (float32 or float64) and
runs `tpwl_select_plain` only for CPU tensors. `tpwl_select.launches`
counts kernel launches. `index_only=k` gives the first k states their index
and no rows: the MPC tick needs only the index at the plan point (for the
DARE gain) and rows at the plant state and the estimate. `distances=True`
adds each state's distance to its chosen point, the value the kernel
compared (the plain version's from `point_distances_batch`): a select over
a dictionary split along its points (parallel/mesh.py) reduces the parts'
minima by it. Each value depends on its state and point alone, so that
reduction, ties to the lowest part, gives the whole dictionary's index.
Every call is the span `tpwl.select` (utils/timing.py), on either path.
"""

from __future__ import annotations

import ctypes

import torch

from soft_robot_control_tpu_torch.ops import build
from soft_robot_control_tpu_torch.utils.timing import span

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_FN = {torch.float32: "tpwl_select_f32", torch.float64: "tpwl_select_f64"}
_LAUNCH_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 6)
_SIGNATURES = {
    "tpwl_select_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 2),
    "tpwl_select_f32": (ctypes.c_int, _LAUNCH_ARGS),
    "tpwl_select_f64": (ctypes.c_int, _LAUNCH_ARGS),
}


def point_distances_batch(x, q_pts, v_pts, dist_w_q, dist_w_v):
    """(B, P) weighted distances w_q ||q - q_i|| + w_v ||v - v_i|| of the
    states x = [v; q] (B, 2r), by direct differences."""
    r = q_pts.shape[1]
    exact = "donot_use_mm_for_euclid_dist"
    dq = torch.cdist(x[:, r:], q_pts, compute_mode=exact)
    dv = torch.cdist(x[:, :r], v_pts, compute_mode=exact)
    return dist_w_q * dq + dist_w_v * dv


def tpwl_select_plain(x, q_pts, v_pts, A_d, B_d, d_d, dist_w_q, dist_w_v,
                      index_only: int = 0, distances: bool = False):
    """The kernel's function in PyTorch: (idx (B,), A (B-k,n,n),
    B (B-k,n,m), d (B-k,n)) of the nearest dictionary point of each state,
    ties to the lowest index; the rows are those of states k = index_only
    on. With `distances`, each state's distance to its point (B,) too."""
    dist = point_distances_batch(x, q_pts, v_pts, dist_w_q, dist_w_v)
    idx = torch.argmin(dist, dim=1)
    rows = idx[index_only:]
    out = idx, A_d[rows], B_d[rows], d_d[rows]
    if distances:
        out += (dist.gather(1, idx[:, None])[:, 0],)
    return out


def _launch(x, q_pts, v_pts, A_d, B_d, d_d, dist_w_q, dist_w_v, k,
            distances=False):
    Bsz = x.shape[0]
    P, r = q_pts.shape
    _, n, m = B_d.shape
    dt = x.dtype
    if dt not in _FN:
        raise TypeError(f"tpwl_select kernel takes float32 or float64, "
                        f"got {dt}")
    args = [x, q_pts, v_pts, A_d, B_d, d_d]
    shapes = [(Bsz, 2 * r), (P, r), (P, r), (P, n, n), (P, n, m), (P, n)]
    for t, s in zip(args, shapes):
        if t.device != x.device or t.dtype != dt or tuple(t.shape) != s:
            raise ValueError(f"tpwl_select: expected {dt} {s} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    lib = build.load("tpwl_select", _SIGNATURES)
    smem = lib.tpwl_select_smem_bytes(r, x.element_size())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"tpwl_select: r={r} needs {smem} bytes of shared "
                         f"memory, more than a block's {_SMEM_LIMIT}")
    args = [t.contiguous() for t in args]
    idx = torch.empty(Bsz, dtype=torch.int64, device=x.device)
    A = torch.empty((Bsz - k, n, n), dtype=dt, device=x.device)
    Bm = torch.empty((Bsz - k, n, m), dtype=dt, device=x.device)
    d = torch.empty((Bsz - k, n), dtype=dt, device=x.device)
    dist = (torch.empty(Bsz, dtype=dt, device=x.device) if distances
            else None)
    fn = getattr(lib, _FN[dt])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(*[t.data_ptr() for t in args], Bsz, P, r, n * n, n * m, n, k,
            float(dist_w_q), float(dist_w_v), idx.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), d.data_ptr(),
            None if dist is None else dist.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tpwl_select launch failed: CUDA error {rc}")
    tpwl_select.launches += 1
    return (idx, A, Bm, d) if dist is None else (idx, A, Bm, d, dist)


def tpwl_select(x, q_pts, v_pts, A_d, B_d, d_d, dist_w_q, dist_w_v,
                index_only: int = 0, distances: bool = False):
    """Nearest-point index of each state of x (B, 2r), and the (A_d, B_d,
    d_d) rows of states index_only.. (B - index_only rows each); with
    `distances`, each state's distance to its point (B,) as a fifth
    output. CUDA tensors go through the kernel, CPU tensors through the
    plain version."""
    k = int(index_only)
    if not 0 <= k <= x.shape[0]:
        raise ValueError(f"tpwl_select: index_only={k} outside "
                         f"[0, {x.shape[0]}]")
    with span("tpwl.select"):
        if x.device.type == "cpu":
            return tpwl_select_plain(x, q_pts, v_pts, A_d, B_d, d_d,
                                     dist_w_q, dist_w_v, k, distances)
        if x.device.type != "cuda":
            raise ValueError(f"tpwl_select: unsupported device {x.device}")
        return _launch(x, q_pts, v_pts, A_d, B_d, d_d, dist_w_q, dist_w_v,
                       k, distances)


tpwl_select.launches = 0
