"""The yardstick of the kernels' roofline shares: the card's peaks and the
work of each hand kernel's launch, counted from the problem's shapes only.

A launch's least time is the larger of its floating-point operations over
the peak rate and its bytes over the memory bandwidth. Each byte a launch
must read or write is counted once, whatever the kernel reads again.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates: float32 outside the tensor
# cores (float64 on the FP64 tensor cores has the same rate), HBM3
PEAK_FLOPS = {4: 67e12, 8: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, elem: int = 4) -> float:
    return max(flops / PEAK_FLOPS[elem], nbytes / PEAK_BYTES_PER_S)


def admm_batched_work(B: int, n: int, m: int, iters: int, elem: int = 4):
    """(flops, bytes) of `iters` fixed ADMM iterations on B QPs of n
    variables and m rows with K^-1 given: each iteration applies K^-1
    (2 n^2) and A and A' (2 m n each); the element-wise updates are left
    out. Bytes: K^-1, A, q, l, u, the warm start in and the solution out
    of every QP, and the shared rho row."""
    flops = B * iters * (2 * n * n + 4 * m * n)
    nbytes = elem * (B * (n * n + m * n + n + 2 * m + 2 * (n + m)) + m)
    return float(flops), float(nbytes)


def tpwl_select_work(S: int, rows: int, P: int, r: int, n: int, m: int,
                     elem: int = 4):
    """(flops, bytes) of a nearest-point select of S states over P points
    of r positions and r velocities, with (A, B, d) rows (n x n, n x m, n)
    copied for `rows` of them: 6 r operations a state and point (a
    difference, a square and a sum in each half); the states, the points,
    each dictionary row read at most once (min(rows, P) of them), the
    indices (8 bytes) and the copied rows out."""
    row = n * n + n * m + n
    flops = S * P * 6 * r
    nbytes = (elem * (S * 2 * r + 2 * P * r + (min(rows, P) + rows) * row)
              + 8 * S)
    return float(flops), float(nbytes)


WORK = {"admm_batched": admm_batched_work, "admm_stream": admm_batched_work,
        "tpwl_select": tpwl_select_work}


def least_time(launches) -> float:
    """Summed least seconds of [(kernel, args)] launches."""
    total = 0.0
    for kernel, args in launches:
        flops, nbytes = WORK[kernel](*args)
        total += least_seconds(flops, nbytes, args[-1])
    return total
