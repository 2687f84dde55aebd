"""Batched fixed-iteration ADMM: B independent QPs in one kernel launch.

Port of the TPU kernel soft_robot_control_tpu/ops/pallas_admm.py
(_admm_chunk_kernel and _admm_kinv_kernel, entry admm_batched_pallas) as
the hand-written CUDA kernel csrc/admm_batched.cu, one warp per QP with
K^-1 and A resident in shared memory for all iterations. The kernel is
bound by the latency of its per-iteration chain of small mat-vecs, not by
bytes or FLOPs; the source says why and what the design does about it.

`admm_batched` launches the kernel for CUDA tensors (float32 or float64)
and runs `admm_batched_plain`, the same arithmetic in PyTorch, only for CPU
tensors. `admm_batched.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from soft_robot_control_tpu_torch.ops import build

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_FN = {torch.float32: "admm_batched_f32", torch.float64: "admm_batched_f64"}
_LAUNCH_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                + [ctypes.c_double] * 2 + [ctypes.c_void_p])
_SIGNATURES = {
    "admm_batched_qp_bytes": (ctypes.c_size_t, [ctypes.c_int] * 3),
    "admm_batched_f32": (ctypes.c_int, _LAUNCH_ARGS),
    "admm_batched_f64": (ctypes.c_int, _LAUNCH_ARGS),
}


def admm_batched_plain(Kinv, A, q, l, u, rho_vec, w0, y0, iters: int,
                       sigma: float = 1e-6, alpha: float = 1.6):
    """The kernel's function in PyTorch. Kinv (B,n,n) symmetric, A (B,m,n),
    q, w0 (B,n), l, u, y0 (B,m), rho_vec (m,) shared. Returns (w, y)."""
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


def _launch(Kinv, A, q, l, u, rho_vec, w0, y0, iters, sigma, alpha):
    B, n = q.shape
    m = A.shape[1]
    dt = Kinv.dtype
    if dt not in _FN:
        raise TypeError(f"admm_batched kernel takes float32 or float64, "
                        f"got {dt}")
    args = [Kinv, A, q, l, u, rho_vec, w0, y0]
    shapes = [(B, n, n), (B, m, n), (B, n), (B, m), (B, m), (m,), (B, n),
              (B, m)]
    for t, s in zip(args, shapes):
        if t.device != Kinv.device or t.dtype != dt or tuple(t.shape) != s:
            raise ValueError(f"admm_batched: expected {dt} {s} on "
                             f"{Kinv.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    lib = build.load("admm_batched", _SIGNATURES)
    per = lib.admm_batched_qp_bytes(n, m, Kinv.element_size())
    if per > _SMEM_LIMIT:
        raise ValueError(f"admm_batched: one QP with n={n}, m={m} needs "
                         f"{per} bytes of shared memory, more than a "
                         f"block's {_SMEM_LIMIT}")
    args = [t.contiguous() for t in args]
    w = torch.empty((B, n), dtype=dt, device=Kinv.device)
    y = torch.empty((B, m), dtype=dt, device=Kinv.device)
    fn = getattr(lib, _FN[dt])
    stream = torch.cuda.current_stream(Kinv.device).cuda_stream
    rc = fn(*[t.data_ptr() for t in args], w.data_ptr(), y.data_ptr(),
            B, n, m, int(iters), float(sigma), float(alpha), stream)
    if rc != 0:
        raise RuntimeError(f"admm_batched launch failed: CUDA error {rc}")
    admm_batched.launches += 1
    return w, y


def admm_batched(Kinv, A, q, l, u, rho_vec, w0, y0, iters: int,
                 sigma: float = 1e-6, alpha: float = 1.6):
    """B fixed-iteration ADMM solves (see admm_batched_plain for the
    shapes). CUDA tensors go through the kernel, CPU tensors through the
    plain version."""
    if Kinv.device.type == "cpu":
        return admm_batched_plain(Kinv, A, q, l, u, rho_vec, w0, y0, iters,
                                  sigma, alpha)
    if Kinv.device.type != "cuda":
        raise ValueError(f"admm_batched: unsupported device {Kinv.device}")
    return _launch(Kinv, A, q, l, u, rho_vec, w0, y0, iters, sigma, alpha)


admm_batched.launches = 0
