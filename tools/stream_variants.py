"""The streaming ADMM kernel (csrc/admm_stream.cu) against two variants that
its plan does not select, on one card: the evidence for two choices in
csrc/admm_cluster.cuh.

    python tools/stream_variants.py      # on a machine with an H100 and nvcc

- "window": the windowed x~ receive on every QP (the plan takes it only
  where full slots do not fit), with plain f32 sums. Timed against the
  built kernel at the shapes of PERF.md rows 3b and 3c (f32 and f64, in
  turns: built, window, window, built) and compared bit for bit with it
  there and at n = m = 1,842 (f64) and 3,684 (f32), where both receives
  fit.
- "plain_sums": the built kernel without the compensated f32 sums of its
  windowed instance. Its error and the built kernel's against the plain
  version in f64 are read as multiples of the plain f32 version's, on the
  card test's QPs (tests/test_torch_kernels_cuda.py) at n = m = 6,624 with
  P of rank 64 plus 0.1 I (seeds 5 to 12) and of full rank (5 to 8), and
  at 1,843 and 3,684 (rank 64, seeds 5 to 8).

Each variant is the checkout's sources with one line replaced, built with
the same nvcc flags under build/stream_variants/. Kernel times are CUDA
events behind a queued sleep (chip_smoke.cuda_ms); QPs of rows 3b and 3c
are chip_smoke.random_qps (the kernel runs a fixed number of iterations,
so its time does not depend on the values). Prints one JSON line with the
card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from soft_robot_control_tpu_torch.ops import admm_batched as ab  # noqa: E402
from soft_robot_control_tpu_torch.ops import build  # noqa: E402
from soft_robot_control_tpu_torch.qp.blocked import make_kinv  # noqa: E402

FORCE_WINDOW = ("  if (residency == kSome && form == kKinv &&\n"
                "      vec > (kMaxSmem - barrier_bytes(0)) / (size_t)elem) {",
                "  if (residency == kSome && form == kKinv) {")
PLAIN_SUMS = ("  constexpr bool kComp = kXW && kElem == 4;",
              "  constexpr bool kComp = false;")
VARIANTS = {"window": (FORCE_WINDOW, PLAIN_SUMS), "plain_sums": (PLAIN_SUMS,)}
# (row, B, n, m, iterations): path A (chip_smoke.py phase 5), GuSTO's
# sparse LOCP (phase 11)
ROWS = (("3b", 1024, 380, 400, 25), ("3c", 64, 386, 1126, 50))


def variant_libs():
    """The streaming kernel of each variant: the checkout's sources with
    the variant's lines replaced, one nvcc a variant, started together."""
    jobs = {}
    for name, lines in VARIANTS.items():
        out = os.path.join(ROOT, "build", "stream_variants", name)
        os.makedirs(out, exist_ok=True)
        for f in ("admm_stream.cu", "admm_cluster.cuh", "admm_matvec.cuh"):
            src = open(os.path.join(build.CSRC, f)).read()
            for old, new in lines if f == "admm_cluster.cuh" else ():
                if src.count(old) != 1:
                    raise RuntimeError(f"{name}: the line to replace is "
                                       f"gone from {f}: {old!r}")
                src = src.replace(old, new)
            open(os.path.join(out, f), "w").write(src)
        so = os.path.join(out, "admm_stream.so")
        jobs[name] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so,
             os.path.join(out, "admm_stream.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    libs = {}
    for name, (so, proc) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}: "
                               f"{proc.stderr.read().decode()}")
        lib = libs[name] = ctypes.CDLL(so)
        for fn, (restype, argtypes) in ab._SIGNATURES["admm_stream"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
    return libs


def solve(lib, args, iters):
    """The streaming kernel of `lib` (None: the built one) on args."""
    if lib is None:
        return ab.admm_stream(*args, iters)
    a = ab._checked("admm_stream", *args)
    return ab._launch(ab.admm_stream, lib, a, iters, 1e-6, 1.6)


def card_test_qps(n, seed, rank, dev):
    """tests/test_torch_kernels_cuda.py's _qps(1, n, n, seed, inf_rows=200,
    rank=rank) built on the card, in f64."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device=dev)
    Ph = t(rng.normal(size=(1, n, rank or n)))
    P = Ph @ Ph.transpose(1, 2) + 0.1 * torch.eye(
        n, dtype=torch.float64, device=dev)
    A = rng.normal(size=(1, n, n))
    mid = np.einsum("bmn,bn->bm", A, rng.normal(size=(1, n)) * 0.2)
    rho = torch.full((n,), 0.1, dtype=torch.float64, device=dev)
    Kinv = make_kinv(P, t(A), rho)
    l = mid - rng.uniform(0.1, 1, (1, n))
    u = mid + rng.uniform(0.1, 1, (1, n))
    l[:, :200] = -np.inf
    u[:, 200:400] = np.inf
    return [Kinv, t(A), t(rng.normal(size=(1, n))), t(l), t(u), rho,
            t(0.1 * rng.normal(size=(1, n))), t(0.1 * rng.normal(size=(1, n)))]


def max_diff(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


def main():
    if not torch.cuda.is_available():
        print("stream_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = {"built": None, **variant_libs()}
    out = {"card": card, "ms": {}, "window_vs_built": {}, "ratios": []}
    inputs = {(row, dt): chip_smoke.random_qps(B, n, m, 0, dt, dev)
              for row, B, n, m, _ in ROWS
              for dt in (torch.float32, torch.float64)}
    for v in ("built", "window", "window", "built"):
        for row, B, n, m, iters in ROWS:
            for dt in (torch.float32, torch.float64):
                args = inputs[(row, dt)]
                ms = chip_smoke.cuda_ms(lambda: solve(libs[v], args, iters),
                                        10)
                out["ms"].setdefault(f"{row} {str(dt)[6:]}", {}).setdefault(
                    v, []).append(ms)
    same = [(f"{row} {str(dt)[6:]}", inputs[(row, dt)])
            for row, *_ in ROWS for dt in (torch.float32, torch.float64)]
    for n, dt in ((1842, torch.float64), (3684, torch.float32)):
        same.append((f"n=m={n} {str(dt)[6:]}", [
            t.to(dt) for t in card_test_qps(n, 5, 64, dev)]))
    for key, args in same:
        out["window_vs_built"][key] = max_diff(
            solve(libs["window"], args, 10), solve(None, args, 10))
    cases = [(6624, 64, s) for s in range(5, 13)]
    cases += [(6624, None, s) for s in range(5, 9)]
    cases += [(n, 64, s) for n in (1843, 3684) for s in range(5, 9)]
    for n, rank, seed in cases:
        a64 = card_test_qps(n, seed, rank, dev)
        exact = ab.admm_batched_plain(*a64, 10)
        a32 = [t.float() for t in a64]
        plain = max_diff(ab.admm_batched_plain(*a32, 10), exact)
        row = dict(n=n, rank=rank, seed=seed, plain_f32_err=plain,
                   x_window=ab.stream_plan_built(n, n, 4)["x_window"])
        for v in ("built", "plain_sums"):
            row[v] = max_diff(solve(libs[v], a32, 10), exact) / plain
        out["ratios"].append(row)
        del a64, a32, exact
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
