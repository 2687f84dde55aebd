"""Batched fixed-iteration ADMM: B independent QPs in one kernel launch.

Port of the TPU kernels soft_robot_control_tpu/ops/pallas_admm.py
_admm_chunk_kernel and _admm_kinv_kernel (entry admm_batched_pallas) as two
hand-written CUDA kernels that compute the same function:

- csrc/admm_batched.cu, one warp per QP with K^-1 and A resident in shared
  memory for all iterations, for QPs that fit a block's shared memory (the
  condensed LOCP, n=20, m=40). It is bound by the latency of its
  per-iteration chain of small mat-vecs.
- csrc/admm_stream.cu, one block per QP with K^-1 and A streamed from
  device memory every iteration, for QPs that do not fit (the sparse LOCP,
  n=380, m=400). It is bound by bytes.

`admm_batched` picks between them from the QP's size; `admm_stream` is the
second kernel's own wrapper and takes any size. Both launch their kernel
for CUDA tensors (float32 or float64) and run `admm_batched_plain`, the
same arithmetic in PyTorch, only for CPU tensors. `admm_batched.launches`
and `admm_stream.launches` count the launches of the two kernels.
"""

from __future__ import annotations

import ctypes

import torch

from soft_robot_control_tpu_torch.ops import build

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_LAUNCH_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                + [ctypes.c_double] * 2 + [ctypes.c_void_p])
_SIGNATURES = {
    "admm_batched": {
        "admm_batched_qp_bytes": (ctypes.c_size_t, [ctypes.c_int] * 3),
        "admm_batched_f32": (ctypes.c_int, _LAUNCH_ARGS),
        "admm_batched_f64": (ctypes.c_int, _LAUNCH_ARGS),
    },
    "admm_stream": {
        "admm_stream_f32": (ctypes.c_int, _LAUNCH_ARGS),
        "admm_stream_f64": (ctypes.c_int, _LAUNCH_ARGS),
    },
}
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


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


def _launch(wrapper, lib, args, iters, sigma, alpha):
    """Launch `wrapper`'s kernel from `lib` on checked args; counts it."""
    name = wrapper.__name__
    Kinv, A = args[0], args[1]
    B, n, m, dt = Kinv.shape[0], Kinv.shape[1], A.shape[1], Kinv.dtype
    w = torch.empty((B, n), dtype=dt, device=Kinv.device)
    y = torch.empty((B, m), dtype=dt, device=Kinv.device)
    stream = torch.cuda.current_stream(Kinv.device).cuda_stream
    rc = getattr(lib, name + _SUFFIX[dt])(
        *[t.data_ptr() for t in args], w.data_ptr(), y.data_ptr(),
        B, n, m, int(iters), float(sigma), float(alpha), stream)
    if rc == -1:
        raise ValueError(f"{name}: a QP with n={n}, m={m} needs more shared "
                         f"memory than a block's {_SMEM_LIMIT} bytes")
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


def admm_batched(Kinv, A, q, l, u, rho_vec, w0, y0, iters: int,
                 sigma: float = 1e-6, alpha: float = 1.6):
    """B fixed-iteration ADMM solves (see admm_batched_plain for the
    shapes). CUDA tensors go through the shared-memory kernel when one QP
    fits a block's shared memory and through the streaming kernel when it
    does not; CPU tensors go through the plain version."""
    if Kinv.device.type == "cpu":
        return admm_batched_plain(Kinv, A, q, l, u, rho_vec, w0, y0, iters,
                                  sigma, alpha)
    args = _checked("admm_batched", Kinv, A, q, l, u, rho_vec, w0, y0)
    lib = build.load("admm_batched", _SIGNATURES["admm_batched"])
    n, m = q.shape[1], A.shape[1]
    if lib.admm_batched_qp_bytes(n, m, Kinv.element_size()) > _SMEM_LIMIT:
        return admm_stream(*args, iters, sigma, alpha)
    return _launch(admm_batched, lib, args, iters, sigma, alpha)


admm_batched.launches = 0
admm_stream.launches = 0
