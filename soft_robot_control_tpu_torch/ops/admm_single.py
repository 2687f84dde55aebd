"""Fixed-iteration ADMM for one QP with the x-step applied as M1' (M1 rhs).

Port of the TPU kernel soft_robot_control_tpu/ops/pallas_admm.py
_admm_kernel (entry admm_pallas, wrapper admm_fixed_pallas) as the
hand-written CUDA kernel csrc/admm_single.cu: one thread-block cluster of 8
blocks, each holding an eighth of the rows of M1 and of A in its shared
memory for all iterations (walked in place, through L2, where the matrices
do not fit the cluster: f64 at the sparse LOCP's size). One QP of that size
is bound by the latency of its chain of four dependent mat-vecs per
iteration; the source says what the design does about it.

`admm_single` launches the kernel for CUDA tensors (float32 or float64) and
runs `admm_single_plain`, the same arithmetic in PyTorch, only for CPU
tensors. `admm_single.launches` counts kernel launches.
`admm_fixed_single` prepares M1 and the clamped bounds from the QP.
`single_plan_built` is the layout the built source exports;
`ops.admm_batched.cluster_plan(..., single=True)` is the same in Python.
"""

from __future__ import annotations

import ctypes

import torch

from soft_robot_control_tpu_torch.ops import build
from soft_robot_control_tpu_torch.ops.admm_batched import (PLAN_FIELDS,
                                                           exported_plan)

_FN = {torch.float32: "admm_single_f32", torch.float64: "admm_single_f64"}
_LAUNCH_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                + [ctypes.c_double] * 2 + [ctypes.c_void_p])
_SIGNATURES = {name: (ctypes.c_int, _LAUNCH_ARGS) for name in _FN.values()}
_SIGNATURES["admm_single_plan"] = (
    ctypes.c_int, [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
_BIG = 1e30  # finite stand-in for an infinite bound


def admm_single_plain(M1, A, q, l, u, rho_vec, w0, y0, iters: int,
                      sigma: float = 1e-6, alpha: float = 1.6):
    """The kernel's function in PyTorch. M1 (n,n) with K^-1 = M1' M1,
    A (m,n), q, w0 (n,), l, u, rho_vec, y0 (m,). Returns (w, y)."""
    w, y = w0, y0
    z = torch.clamp(A @ w, l, u)
    for _ in range(int(iters)):
        rhs = sigma * w - q + A.T @ (rho_vec * z - y)
        x_t = M1.T @ (M1 @ rhs)
        z_t = A @ x_t
        w = alpha * x_t + (1 - alpha) * w
        z_rel = alpha * z_t + (1 - alpha) * z
        z_new = torch.clamp(z_rel + y / rho_vec, l, u)
        y = y + rho_vec * (z_rel - z_new)
        z = z_new
    return w, y


def _launch(M1, A, q, l, u, rho_vec, w0, y0, iters, sigma, alpha):
    n, m = q.shape[0], A.shape[0]
    dt = M1.dtype
    if dt not in _FN:
        raise TypeError(f"admm_single kernel takes float32 or float64, "
                        f"got {dt}")
    args = [M1, A, q, l, u, rho_vec, w0, y0]
    shapes = [(n, n), (m, n), (n,), (m,), (m,), (m,), (n,), (m,)]
    for t, s in zip(args, shapes):
        if t.device != M1.device or t.dtype != dt or tuple(t.shape) != s:
            raise ValueError(f"admm_single: expected {dt} {s} on "
                             f"{M1.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    lib = build.load("admm_single", _SIGNATURES)
    args = [t.contiguous() for t in args]
    w = torch.empty(n, dtype=dt, device=M1.device)
    y = torch.empty(m, dtype=dt, device=M1.device)
    stream = torch.cuda.current_stream(M1.device).cuda_stream
    rc = getattr(lib, _FN[dt])(
        *[t.data_ptr() for t in args], w.data_ptr(), y.data_ptr(),
        n, m, int(iters), float(sigma), float(alpha), stream)
    if rc == -1:
        raise ValueError(f"admm_single: a QP with n={n}, m={m} needs more "
                         "shared memory for its vectors than a block has")
    if rc != 0:
        raise RuntimeError(f"admm_single launch failed: CUDA error {rc}")
    admm_single.launches += 1
    return w, y


def admm_single(M1, A, q, l, u, rho_vec, w0, y0, iters: int,
                sigma: float = 1e-6, alpha: float = 1.6):
    """One fixed-iteration ADMM solve (see admm_single_plain for the
    shapes). CUDA tensors go through the kernel, CPU tensors through the
    plain version."""
    if M1.device.type == "cpu":
        return admm_single_plain(M1, A, q, l, u, rho_vec, w0, y0, iters,
                                 sigma, alpha)
    if M1.device.type != "cuda":
        raise ValueError(f"admm_single: unsupported device {M1.device}")
    return _launch(M1, A, q, l, u, rho_vec, w0, y0, iters, sigma, alpha)


admm_single.launches = 0


def single_plan_built(n: int, m: int, elem_size: int):
    """The layout of a QP over the kernel's cluster as the built
    csrc/admm_single.cu exports it (ops.admm_batched.PLAN_FIELDS), or None
    where not even the vectors fit. Needs the CUDA toolkit."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    lib = build.load("admm_single", _SIGNATURES)
    if lib.admm_single_plan(n, m, elem_size, out) != 0:
        return None
    return exported_plan(out)


def prepare_single(P, A, l, u, rho_vec, sigma: float = 1e-6):
    """(M1, l, u) for admm_single from one QP: M1 = inv(chol(D K D)) D with
    K = P + sigma I + A' diag(rho) A and D = diag(K)^-1/2, so that
    K^-1 = M1' M1. Inverting the Jacobi-scaled triangular factor keeps the
    f32 error near kappa(L_s) eps, where the explicit inverse of the raw K
    (whose equality-row rho boost drives kappa(K) past f32 range) does not;
    one Newton step X <- X(2I - L_s X), in full f32, cleans up the
    triangular inversion. Infinite bounds become +-1e30."""
    n = P.shape[0]
    I = torch.eye(n, dtype=P.dtype, device=P.device)
    K = P + sigma * I + (A.T * rho_vec[None, :]) @ A
    d = torch.rsqrt(torch.diagonal(K))
    Ls = torch.linalg.cholesky(K * d[:, None] * d[None, :])
    Linv = torch.linalg.solve_triangular(Ls, I, upper=False)
    Linv = Linv @ (2.0 * I - Ls @ Linv)
    return Linv * d[None, :], torch.clamp(l, min=-_BIG), torch.clamp(
        u, max=_BIG)


def admm_fixed_single(P, q, A, l, u, w0, y0, rho_vec, iters: int,
                      sigma: float = 1e-6, alpha: float = 1.6):
    """Warm-started fixed-iteration ADMM on one QP (P (n,n), A (m,n))
    through the single-QP kernel. Returns (w, y)."""
    M1, l_f, u_f = prepare_single(P, A, l, u, rho_vec, sigma)
    return admm_single(M1, A, q, l_f, u_f, rho_vec, w0, y0, iters, sigma,
                       alpha)
