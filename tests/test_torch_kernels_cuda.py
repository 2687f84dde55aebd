"""The port's CUDA kernels on the card, against their plain versions.

These tests import neither JAX nor the JAX package, so that they run on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

(`--noconftest` skips tests/conftest.py, which configures JAX). Without a
card every test here skips.
"""

import numpy as np
import pytest
import torch

from torch_helpers import (CAMPAIGN_PARAMS, GOLDEN_CHAIN,  # noqa: F401
                           SSM_ARTIFACTS, LiftedPlant, TLin, campaign_dict,
                           campaign_output_maps, campaign_scp, cuda_device,
                           golden_loop, ssm_targets)

from soft_robot_control_tpu_torch.control import batch_mpc
from soft_robot_control_tpu_torch.control.batch_mpc import (BatchMPC,
                                                            BatchSSMMPC)
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
from soft_robot_control_tpu_torch.models.ssm import from_mat
from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
from soft_robot_control_tpu_torch.ops import build
from soft_robot_control_tpu_torch.ops.admm_batched import (
    PLAN_FIELDS, _SIGNATURES, admm_batched, admm_batched_plain, admm_cluster,
    admm_stream, batched_form, batched_form_built, block_layout,
    block_layout_built, cluster_max_active, cluster_plan, cluster_plan_built,
    kernel_for, qp_bytes, stream_max_active, stream_plan_built)
from soft_robot_control_tpu_torch.ops.admm_single import (admm_single,
                                                          admm_single_plain,
                                                          prepare_single,
                                                          single_plan_built)
from soft_robot_control_tpu_torch.ops.tpwl_select import (
    point_distances_batch, tpwl_select, tpwl_select_plain)
from soft_robot_control_tpu_torch.qp.blocked import make_kinv
from soft_robot_control_tpu_torch.scp import gusto_jit
from soft_robot_control_tpu_torch.scp.gusto_jit import GuSTOJit
from soft_robot_control_tpu_torch.sim.closed_loop import run_closed_loop

pytestmark = pytest.mark.cuda


def _qps(B, n, m, seed, inf_rows=0, device="cpu", rank=None):
    """Random feasible QPs with K^-1 from the port's make_kinv (f64, P and
    K^-1 built on `device`); P = Ph Ph^T + 0.1 I with Ph of `rank` columns
    (n by default); the first `inf_rows` rows have no lower bound, the
    next as many no upper."""
    rng = np.random.default_rng(seed)
    Ph = rng.normal(size=(B, n, rank or n))
    P = torch.as_tensor(Ph, device=device)
    P = P @ P.transpose(1, 2) + 0.1 * torch.eye(n, dtype=P.dtype,
                                                device=device)
    A = rng.normal(size=(B, m, n))
    mid = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.2)
    rho = torch.full((m,), 0.1, dtype=torch.float64)
    A = torch.as_tensor(A)
    Kinv = make_kinv(P, A.to(device), rho.to(device)).cpu()
    l = mid - rng.uniform(0.1, 1, (B, m))
    u = mid + rng.uniform(0.1, 1, (B, m))
    l[:, :inf_rows] = -np.inf
    u[:, inf_rows:2 * inf_rows] = np.inf
    return [Kinv, A, torch.as_tensor(rng.normal(size=(B, n))),
            torch.as_tensor(l), torch.as_tensor(u), rho,
            torch.as_tensor(0.1 * rng.normal(size=(B, n))),
            torch.as_tensor(0.1 * rng.normal(size=(B, m)))]


def _assert_close(got, ref, dtype, tol):
    """Max abs error within tol (f64) or tol times the solution's scale
    (f32: the kernels sum in another order than the plain version)."""
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        scale = 1.0 if dtype == torch.float64 else max(
            float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= tol * scale


@pytest.mark.parametrize("B", [1, 3, 37, 1024])
@pytest.mark.parametrize("n,m", [(20, 40), (7, 13), (33, 70), (100, 120),
                                 (21, 641), (80, 160)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_admm_kernel_matches_plain(cuda_device, B, n, m, dtype, tol):
    """Kernel 1 in its register form (f32 at the condensed LOCP's size and
    at a ragged smaller one) and its block form (f64, past 32 variables,
    and at the sizes of GuSTO's condensed LOCP with its trust region, odd
    n=21 and m=641, and of the LTI service's LOCP, n=80 and m=160), with
    infinite bounds on some rows, at a ragged B too."""
    args = [t.to(cuda_device, dtype) for t in _qps(B, n, m, seed=B,
                                                   inf_rows=m // 8)]
    assert kernel_for(n, m, args[0].element_size()) == "admm_batched"
    launches = admm_batched.launches
    w1, y1 = admm_batched(*args, 25)
    w2, y2 = admm_batched_plain(*args, 25)
    torch.cuda.synchronize()
    assert admm_batched.launches == launches + 1
    _assert_close((w1, y1), (w2, y2), dtype, tol)


@pytest.mark.parametrize("B,n,m", [(1, 380, 400), (3, 380, 400),
                                   (64, 380, 400), (5, 12, 16), (2, 70, 33),
                                   (1, 386, 1126), (3, 386, 1126),
                                   (64, 386, 1126)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_stream_kernel_matches_plain(cuda_device, B, n, m, dtype, tol):
    """Kernel 3's streaming form at the sparse LOCP's size, at GuSTO's
    sparse LOCP's (n=386, rows not a multiple of 16 bytes in f32, m=1126;
    part of each block's rows walked in place) and at small ragged sizes
    (every row resident, clusters of fewer than 8 blocks), with infinite
    bounds, at B = 1, 3 and 64."""
    args = [t.to(cuda_device, dtype) for t in _qps(B, n, m, seed=n,
                                                   inf_rows=m // 8)]
    launches = admm_stream.launches
    got = admm_stream(*args, 25)
    ref = admm_batched_plain(*args, 25)
    torch.cuda.synchronize()
    assert admm_stream.launches == launches + 1
    _assert_close(got, ref, dtype, tol)


def _shifted_and_strided(args):
    """The same tensors as a view 4 bytes into its storage (no 16-byte
    loads) and as a non-contiguous view of K^-1."""
    shifted = []
    for t in args:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        shifted.append(buf[1:].view(t.shape))
    assert shifted[0].data_ptr() % 16 == args[0].element_size()
    strided = [args[0].transpose(1, 2).contiguous().transpose(1, 2)] + args[1:]
    return shifted, strided


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_stream_kernel_takes_unaligned_and_strided_inputs(cuda_device, dtype,
                                                          tol):
    """Unaligned rows walked in place and copied into shared memory element
    by element, and a non-contiguous K^-1: the same answers."""
    args = [t.to(cuda_device, dtype) for t in _qps(3, 386, 1126, seed=2,
                                                   inf_rows=140)]
    ref = admm_batched_plain(*args, 20)
    for a in _shifted_and_strided(args):
        got = admm_stream(*a, 20)
        torch.cuda.synchronize()
        _assert_close(got, ref, dtype, tol)


# the block form's shapes on the paths (GuSTO condensed, LTI, ROMPC,
# Koopman MPC, the trunk SSM's sparse LOCP) and chip_smoke.py's (100, 120)
BLOCK_SHAPES = [(21, 641), (80, 160), (80, 1), (40, 152), (48, 24),
                (100, 120)]


@pytest.mark.parametrize("n,m", BLOCK_SHAPES)
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_block_form_matches_plain(cuda_device, n, m, B, dtype, tol):
    """Kernel 1's block form at the paths' shapes, at B = 1, 3 and 64, with
    infinite bounds on a quarter of the rows: one launch, the plain
    version's answer."""
    args = [t.to(cuda_device, dtype) for t in _qps(B, n, m, seed=n + B,
                                                   inf_rows=m // 8)]
    assert batched_form(n, m, args[0].element_size()) == "block"
    launches = admm_batched.launches
    got = admm_batched(*args, 40)
    ref = admm_batched_plain(*args, 40)
    torch.cuda.synchronize()
    assert admm_batched.launches == launches + 1
    _assert_close(got, ref, dtype, tol)


@pytest.mark.parametrize("B,n,m,dtype,tol", [
    (133, 21, 641, torch.float32, 1e-4), (400, 21, 641, torch.float32, 1e-4),
    (400, 40, 152, torch.float64, 1e-9)])
def test_block_form_at_the_thread_counts_of_large_batches(cuda_device, B, n,
                                                          m, dtype, tol):
    """The block form where the batch puts two or three blocks on an SM,
    so that its rule gives fewer threads than a lone block takes (512 and
    320 where 672 and 544): the same answers."""
    args = [t.to(cuda_device, dtype) for t in _qps(B, n, m, seed=4,
                                                   inf_rows=m // 8)]
    elem = args[0].element_size()
    assert block_layout(B, n, m, elem)["threads"] < block_layout(
        1, n, m, elem)["threads"]
    got = admm_batched(*args, 30)
    ref = admm_batched_plain(*args, 30)
    torch.cuda.synchronize()
    _assert_close(got, ref, dtype, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_block_form_takes_unaligned_and_strided_inputs(cuda_device, dtype,
                                                       tol):
    args = [t.to(cuda_device, dtype) for t in _qps(3, 40, 152, seed=3,
                                                   inf_rows=19)]
    ref = admm_batched_plain(*args, 30)
    for a in _shifted_and_strided(args):
        got = admm_batched(*a, 30)
        torch.cuda.synchronize()
        _assert_close(got, ref, dtype, tol)


@pytest.mark.parametrize("n,dtype,rank,seed", [
    (3312, torch.float64, None, 5), (6624, torch.float32, None, 5),
    (6624, torch.float32, 64, 5), (6624, torch.float32, 64, 7),
    (6624, torch.float32, 64, 10), (2641, torch.float64, None, 5)])
def test_stream_kernel_takes_qps_up_to_its_vectors(cuda_device, n, dtype,
                                                   rank, seed):
    """The streaming kernel's largest square QPs (n = m = 3,312 in f64 and
    6,624 in f32: x~ received in windows, its vectors fill a block, every
    row is walked in place) and the earlier one-block design's f64 end
    (2,641, which the full-slot plan refused) run. In f64 within 1e-9 of
    the solution's scale of the plain version. In f32 each of the 6,624
    terms of a sum rounds, and the kernel (compensated sums) and the plain
    version sum in other orders: the kernel's error against the plain
    version in f64 on the same inputs is held within twice the plain f32
    version's (SSM_F32_ROUNDING_RATIO's rule in chip_smoke.py), on a P of
    full rank and on ill-conditioned ones (rank 64 plus 0.1 I; the seeds
    where plain sums in the kernel read 1.60x, 2.18x and 2.12x). One more
    variable and row past the end, and the launch raises."""
    elem = torch.empty((), dtype=dtype).element_size()
    plan = stream_plan_built(n, n, elem)
    assert plan == {k: cluster_plan(n, n, elem, stream=True)[k]
                    for k in PLAN_FIELDS}
    assert plan["x_window"]
    args = [t.to(cuda_device, dtype) for t in _qps(
        1, n, n, seed=seed, inf_rows=200, device=cuda_device, rank=rank)]
    got = admm_stream(*args, 10)
    ref = admm_batched_plain(*args, 10)
    exact = admm_batched_plain(*[t.double() for t in args], 10)
    torch.cuda.synchronize()
    scale = max(max(float(r.abs().max()) for r in exact), 1.0)
    for a, b, e in zip(got, ref, exact):
        assert bool(torch.isfinite(a).all())
        if dtype == torch.float64:
            assert float((a - b).abs().max()) <= 1e-9 * scale
        else:
            plain_err = float((b.double() - e).abs().max())
            assert float((a.double() - e).abs().max()) <= 2.0 * plain_err
    if n == 2641:
        return
    assert stream_plan_built(n + 1, n + 1, elem) is None
    args = [t.to(cuda_device, dtype) for t in _qps(
        1, n + 1, n + 1, seed=5, device=cuda_device)]
    launches = admm_stream.launches
    with pytest.raises(ValueError, match="shared memory"):
        admm_stream(*args, 10)
    assert admm_stream.launches == launches


# the sparse LOCP's size, ragged sizes (n, m not multiples of the cluster
# size or of 32; rows not a multiple of 16 bytes), and QPs with fewer rows
# than the cluster has blocks
CLUSTER_CASES = [(1, 380, 400, None), (3, 380, 400, 8), (2, 380, 400, 6),
                 (5, 12, 16, 8), (2, 70, 33, 3), (3, 5, 7, 8),
                 (2, 130, 141, None)]


@pytest.mark.parametrize("B,n,m,R", CLUSTER_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_cluster_kernel_matches_plain(cuda_device, B, n, m, R, dtype, tol):
    """The cluster-resident kernel at the sparse LOCP's size and at ragged
    sizes, with infinite bounds, on the smallest cluster that holds the QP
    (R None) and on named cluster sizes. The sparse LOCP in f64 fits no
    cluster: there the wrapper raises."""
    args = [t.to(cuda_device, dtype) for t in _qps(B, n, m, seed=n,
                                                   inf_rows=m // 8)]
    launches = admm_cluster.launches
    if cluster_plan(n, m, args[0].element_size(), R) is None:
        with pytest.raises(ValueError, match="more shared memory"):
            admm_cluster(*args, 25, cluster_size=R)
        assert admm_cluster.launches == launches
        return
    got = admm_cluster(*args, 25, cluster_size=R)
    ref = admm_batched_plain(*args, 25)
    torch.cuda.synchronize()
    assert admm_cluster.launches == launches + 1
    _assert_close(got, ref, dtype, tol)


def test_cluster_kernel_takes_unaligned_and_strided_inputs(cuda_device):
    """A view that starts 4 bytes into its storage (no 16-byte loads) and a
    non-contiguous one: same answers."""
    args = [t.to(cuda_device, torch.float32) for t in _qps(2, 64, 72, seed=1)]
    ref = admm_batched_plain(*args, 20)
    for a in _shifted_and_strided(args):
        got = admm_cluster(*a, 20, cluster_size=4)
        torch.cuda.synchronize()
        _assert_close(got, ref, torch.float32, 1e-4)


def test_admm_batched_dispatches_by_size(cuda_device):
    """A QP that fits a block's shared memory goes to the warp-per-QP
    kernel, one that fits a cluster's to the cluster-resident kernel, one
    beyond to the streaming kernel, by `kernel_for`'s rule; all agree with
    the one plain version."""
    wrappers = {"admm_batched": admm_batched, "admm_cluster": admm_cluster,
                "admm_stream": admm_stream}
    for (n, m, dtype), want in (((20, 40, torch.float64), "admm_batched"),
                                ((20, 40, torch.float32), "admm_batched"),
                                ((200, 400, torch.float64), "admm_cluster"),
                                ((380, 400, torch.float32), "admm_cluster"),
                                ((380, 400, torch.float64), "admm_stream")):
        args = [t.to(cuda_device, dtype) for t in _qps(2, n, m, seed=0)]
        assert kernel_for(n, m, args[0].element_size()) == want
        before = {k: w.launches for k, w in wrappers.items()}
        got = admm_batched(*args, 10)
        torch.cuda.synchronize()
        assert {k: w.launches - before[k] for k, w in wrappers.items()} == {
            k: int(k == want) for k in wrappers}
        _assert_close(got, admm_batched_plain(*args, 10), dtype,
                      1e-9 if dtype == torch.float64 else 1e-4)


@pytest.mark.parametrize("n,m", [(380, 400), (252, 264), (200, 400),
                                 (20, 40), (70, 33), (5, 7), (130, 141)])
@pytest.mark.parametrize("elem", [4, 8])
def test_plan_agrees_with_the_built_sources(cuda_device, n, m, elem):
    """The Python plan and byte counts against what the .cu files export."""
    lib = build.load("admm_batched", _SIGNATURES["admm_batched"])
    assert qp_bytes(n, m, elem) == lib.admm_batched_qp_bytes(n, m, elem)
    for nn, mm in ((n, m), (min(n, 32), min(m, 64)), (24, 48), (25, 48),
                   (24, 49), (32, 65), (33, 64), (21, 641), (80, 160),
                   (80, 1), (40, 152), (48, 24), (100, 120)):
        assert batched_form_built(nn, mm, elem) == batched_form(nn, mm, elem)
        for B in (1, 3, 64, 133, 1024):
            if qp_bytes(nn, mm, elem) <= 232448:
                assert block_layout_built(B, nn, mm, elem) == block_layout(
                    B, nn, mm, elem)
    for R in (0, 1, 6, 8):
        want = cluster_plan(n, m, elem, R or None)
        got = cluster_plan_built(n, m, elem, R)
        assert (got is None) == (want is None)
        if got is not None:
            assert got == {k: want[k] for k in PLAN_FIELDS}
            assert 1 <= cluster_max_active(n, m, elem, R) <= 132
    want = cluster_plan(n, m, elem, single=True)
    assert single_plan_built(n, m, elem) == {k: want[k] for k in PLAN_FIELDS}
    want = cluster_plan(n, m, elem, stream=True)
    assert stream_plan_built(n, m, elem) == {k: want[k] for k in PLAN_FIELDS}
    # at most two blocks of 768 threads an SM
    assert 1 <= stream_max_active(n, m, elem) <= 2 * 132 // want["R"]


@pytest.mark.parametrize("n,m", [(380, 400), (30, 40), (70, 33), (252, 264),
                                 (5, 9), (131, 77)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_single_kernel_matches_plain(cuda_device, n, m, dtype, tol):
    """Kernel 4 with a boosted rho on equality rows and clamped infinite
    bounds, from the wrapper's own preparation: resident in the cluster's
    shared memory (f32, and f64 at the smaller sizes), walked in place
    (f64 at n=380), ragged sizes, and fewer rows than blocks."""
    rng = np.random.default_rng(n)
    Ph = rng.normal(size=(n, n))
    P = torch.as_tensor(Ph @ Ph.T + 0.1 * np.eye(n))
    A = torch.as_tensor(rng.normal(size=(m, n)))
    mid = A.numpy() @ (0.2 * rng.normal(size=n))
    l = mid - rng.uniform(0.1, 1, m)
    u = mid + rng.uniform(0.1, 1, m)
    l[:5] = u[:5]
    l[5:8] = -np.inf
    rho = 0.1 * np.ones(m)
    rho[:5] *= 1000
    l, u, rho = (torch.as_tensor(a) for a in (l, u, rho))
    M1, l_f, u_f = prepare_single(P, A, l, u, rho)
    args = [t.to(cuda_device, dtype) for t in (
        M1, A, torch.as_tensor(rng.normal(size=n)), l_f, u_f, rho,
        torch.zeros(n, dtype=torch.float64),
        torch.zeros(m, dtype=torch.float64))]
    launches = admm_single.launches
    got = admm_single(*args, 50)
    ref = admm_single_plain(*args, 50)
    torch.cuda.synchronize()
    assert admm_single.launches == launches + 1
    _assert_close(got, ref, dtype, tol)


@pytest.fixture(scope="module")
def campaign_states():
    """The full campaign dictionary (P=1087) on the card, 5119 states near
    it (f64), and which of them are near-ties (f64 gap under 1e-6
    relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    model = from_tpwl_dict(campaign_dict(), params=CAMPAIGN_PARAMS,
                           device=dev)
    rng = np.random.default_rng(5)
    X = torch.cat([model.v, model.q], dim=1)
    pts = torch.as_tensor(rng.integers(0, model.num_points, 5119), device=dev)
    noise = torch.as_tensor(rng.normal(size=(5119, 60)), device=dev)
    x = X[pts] + 0.05 * X.std(dim=0) * noise
    d = point_distances_batch(x, model.q, model.v, 10.0, 1.0)
    two = torch.topk(d, 2, dim=1, largest=False).values
    return model, x, (two[:, 1] - two[:, 0]) < 1e-6 * two[:, 0]


def _assert_select_agrees(got, ref, near_tie, k):
    """Identical indices except at near-ties, bitwise-equal rows (states
    k..) wherever the indices agree."""
    torch.cuda.synchronize()
    same = got[0] == ref[0]
    assert bool((same | near_tie).all())
    for a, b in zip(got[1:], ref[1:]):
        assert a.shape[0] == got[0].shape[0] - k
        assert torch.equal(a[same[k:]], b[same[k:]])


@pytest.mark.parametrize("B", [1, 7, 3072, 5119])
@pytest.mark.parametrize("third", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_select_kernel_matches_plain(campaign_states, B, third, dtype):
    """On the full campaign dictionary (P=1087), with index_only = 0, B/3
    and B: identical indices except at near-ties, and bitwise-equal rows
    wherever the indices agree."""
    model, x, near_tie = campaign_states
    k = B * third // 3
    m = model.to(dtype=dtype)
    dic = (m.q, m.v, m.A_d, m.B_d, m.d_d, 10.0, 1.0)
    launches = tpwl_select.launches
    got = tpwl_select(x[:B].to(dtype), *dic, index_only=k)
    assert tpwl_select.launches == launches + 1
    _assert_select_agrees(got, tpwl_select_plain(x[:B].to(dtype), *dic, k),
                          near_tie[:B], k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_select_kernel_takes_misaligned_views_and_nan_states(
        campaign_states, dtype):
    """x a slice at an odd offset, the dictionary and the row arrays views
    that start one element into their storage (no 16-byte copies), and a
    NaN state, which gets index 0 as torch.argmin gives it."""
    model, x, near_tie = campaign_states
    m = model.to(dtype=dtype)
    B = 301

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    xs = shifted(x[:B].to(dtype))
    xs[5] = float("nan")
    near = near_tie[:B].clone()
    near[5] = False
    dic = [shifted(t) for t in (m.q, m.v, m.A_d, m.B_d, m.d_d)]
    assert dic[0].data_ptr() % 16 != 0 and xs.data_ptr() % 16 != 0
    for k in (0, 100):
        got = tpwl_select(xs, *dic, 10.0, 1.0, index_only=k)
        ref = tpwl_select_plain(xs, m.q, m.v, m.A_d, m.B_d, m.d_d, 10.0, 1.0,
                                k)
        assert int(got[0][5]) == 0 and int(ref[0][5]) == 0
        _assert_select_agrees(got, ref, near, k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_select_kernel_with_an_odd_coordinate_count(campaign_states, dtype):
    """r = 29 (the campaign's first 29 coordinates): the kernel loads one
    coordinate at a time there, two where r is even; same agreement."""
    model, x, _ = campaign_states
    r = 29
    q, v = model.q[:, :r], model.v[:, :r]
    xr = torch.cat([x[:, :r], x[:, 30:30 + r]], dim=1)[:777]
    d = point_distances_batch(xr, q, v, 10.0, 1.0)
    two = torch.topk(d, 2, dim=1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) < 1e-6 * two[:, 0]
    dic = [t.to(dtype).contiguous() for t in (q, v, model.A_d, model.B_d,
                                              model.d_d)]
    for k in (0, 259):
        got = tpwl_select(xr.to(dtype), *dic, 10.0, 1.0, index_only=k)
        ref = tpwl_select_plain(xr.to(dtype), *dic, 10.0, 1.0, k)
        _assert_select_agrees(got, ref, near_tie, k)


# the kernel's distance to the point it chose against the plain version's
# (torch.cdist) at the same point: each sums the squared differences of r
# coordinates in its own order, a few ulps of the distance apart
SELECT_DIST_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.mark.parametrize("B,k", [(5119, 0), (3072, 1024), (1, 0)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_select_kernel_gives_the_distance_it_compared(campaign_states, B, k,
                                                      dtype):
    """distances=True: the same indices and rows as without it, one launch,
    and each state's distance to its point within SELECT_DIST_TOL of the
    plain version's, relative."""
    model, x, near_tie = campaign_states
    m = model.to(dtype=dtype)
    dic = (m.q, m.v, m.A_d, m.B_d, m.d_d, 10.0, 1.0)
    xs = x[:B].to(dtype)
    launches = tpwl_select.launches
    got = tpwl_select(xs, *dic, index_only=k, distances=True)
    assert tpwl_select.launches == launches + 1
    plain = tpwl_select(xs, *dic, index_only=k)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], plain))
    ref = tpwl_select_plain(xs, *dic, k, distances=True)
    _assert_select_agrees(got[:4], ref[:4], near_tie[:B], k)
    same = got[0] == ref[0]
    err = ((got[4] - ref[4]).abs() / ref[4])[same]
    assert float(err.max()) <= SELECT_DIST_TOL[dtype]


@pytest.mark.parametrize("mp", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_select_is_the_kernels_select(campaign_states, mp, dtype):
    """The dictionary split over mp parts of the card (parallel/mesh.py): at
    the plan's B=5119, the tick's B=3072 with index_only=1024 and B=1, the
    same indices as the unsharded kernel everywhere, near-ties included,
    and the same rows bit for bit; mp index-only launches a select."""
    from soft_robot_control_tpu_torch.parallel.mesh import (PointShards,
                                                            make_mesh)

    model, x, _ = campaign_states
    m = model.to(dtype=dtype)
    dev = torch.device("cuda")
    mesh = make_mesh(1, mp, devices=[dev] * mp)
    shards = PointShards(m, mesh)
    dic = (m.q, m.v, m.A_d, m.B_d, m.d_d, 10.0, 1.0)
    for B, k in ((5119, 0), (3072, 1024), (1, 0)):
        xs = x[:B].to(dtype)
        ref = tpwl_select(xs, *dic, index_only=k)
        launches = tpwl_select.launches
        got = shards.select(xs, mesh.devices[0], index_only=k)
        assert tpwl_select.launches == launches + mp
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got[:4], ref))


def test_closed_loop_on_the_card_matches_the_cpu(cuda_device):
    """BatchMPC on a 64-point campaign subset: the card's f32 loop goes
    through both kernels and agrees with the f64 CPU loop."""
    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    Cf, Hf = campaign_output_maps()
    B, n_win = 16, 3
    logs, counts = {}, {}
    for dev, dt in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        model = from_tpwl_dict(data, params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf,
                               device=dev)
        mpc = BatchMPC(model, 100.0 * np.eye(3), 1e-5 * np.eye(4), N=5,
                       dt=0.01, N_replan=2, qp_iters=100, rho_stages=4,
                       U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
                       W=1e-2 * np.eye(60), V=1e-4 * np.eye(30), dtype=dt,
                       device=dev, formulation="condensed")
        z_ref = model.z_ref.cpu().numpy()
        t = 0.01 * np.arange(n_win * 2 + 6)
        zt = z_ref + 2.0 * np.sin(2 * np.pi * t[:, None] / 0.5)
        zt = np.stack([np.stack([zt[2 * w:2 * w + 6] for w in range(n_win)])]
                      * B)
        admm_batched.launches = tpwl_select.launches = 0
        out = mpc.build_fused(n_win)(np.zeros((B, 60)), np.zeros((B, 60)),
                                     zt)
        counts[str(dev)] = (admm_batched.launches, tpwl_select.launches)
        logs[str(dev)] = out["z"].double().cpu().numpy()
    assert counts[str(cuda_device)] == (4 * n_win, 3 * n_win)
    assert counts["cpu"] == (0, 0)
    ref = logs["cpu"]
    diff = np.linalg.norm(logs[str(cuda_device)] - ref)
    assert diff <= 1e-4 * np.linalg.norm(ref - ref.mean(axis=(0, 1)))


@pytest.mark.parametrize("path", ["fused", "single_qp"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-2),
                                       (torch.float64, 1e-6)])
def test_sparse_closed_loop_on_the_card_matches_the_cpu(cuda_device, path,
                                                        dtype, tol):
    """Sparse BatchMPC on a 64-point campaign subset (n=380, m=400): the
    card's loop goes through the cluster-resident kernel in f32 and the
    streaming kernel in f64 (`build_fused`, four launches a window) or the
    single-QP kernel (`build` with use_pallas,
    one launch a window) and agrees with the f64 CPU loop: in f64 to 1e-6
    of the output's variation, in f32 to 5e-2 of it (the equality rows'
    1e3 rho boost amplifies f32 rounding in K^-1, and two windows from
    rest move the output little)."""
    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    Cf, Hf = campaign_output_maps()
    n_win = 2
    fused = path == "fused"
    B = 4 if fused else 1
    kw = (dict(x_step="kinv", qp_iters=100, rho_stages=4) if fused
          else dict(use_pallas=True, qp_iters=50))
    logs, counts = {}, {}
    for dev, dt in ((cuda_device, dtype), ("cpu", torch.float64)):
        model = from_tpwl_dict(data, params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf,
                               device=dev)
        mpc = BatchMPC(model, 100.0 * np.eye(3),
                       (1e-5 if fused else 1e-3) * np.eye(4), N=5, dt=0.01,
                       N_replan=2,
                       U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
                       W=1e-2 * np.eye(60), V=1e-4 * np.eye(30), dtype=dt,
                       device=dev, **kw)
        assert mpc._qp_dims() == (380, 400)
        z_ref = model.z_ref.cpu().numpy()
        t = 0.01 * np.arange(n_win * 2 + 6)
        zt = z_ref + 2.0 * np.sin(2 * np.pi * t[:, None] / 0.5)
        zt = np.stack([np.stack([zt[2 * w:2 * w + 6] for w in range(n_win)])]
                      * B)
        admm_batched.launches = admm_stream.launches = 0
        admm_cluster.launches = 0
        admm_single.launches = tpwl_select.launches = 0
        x0 = np.zeros((B, 60))
        out = (mpc.build_fused(n_win)(x0, x0, zt) if fused
               else mpc.build(n_win)(x0[0], x0[0], zt[0]))
        counts[str(dev)] = (admm_batched.launches, admm_cluster.launches,
                            admm_stream.launches, admm_single.launches,
                            tpwl_select.launches)
        logs[str(dev)] = out["z"].double().cpu().numpy()
    f32 = dtype == torch.float32
    assert counts[str(cuda_device)] == (
        (0, 4 * n_win * f32, 4 * n_win * (not f32), 0, 3 * n_win) if fused
        else (0, 0, 0, n_win, 3 * n_win))
    assert counts["cpu"] == (0, 0, 0, 0, 0)
    ref = logs["cpu"]
    diff = np.linalg.norm(logs[str(cuda_device)] - ref)
    assert diff <= tol * np.linalg.norm(ref - ref.mean(axis=-2,
                                                       keepdims=True))


def _gusto(dev, dtype, formulation, B):
    """bench.py section 4's GuSTOJit on a 64-point campaign subset and a
    batch of B problems from its inputs."""
    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    Cf, Hf = campaign_output_maps()
    model = from_tpwl_dict(data, params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf,
                           discr_method="be", device=dev)
    gj = GuSTOJit(TPWLGuSTO(model), N=5, dt=0.01, Qz=100.0 * np.eye(3),
                  R=1e-3 * np.eye(4),
                  U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
                  max_iters=5, qp_iters=50, x_step="kinv",
                  formulation=formulation, dtype=dtype)
    rng = np.random.default_rng(2)
    x0 = 0.05 * rng.normal(size=(B, 60))
    z = np.repeat(model.z_ref.cpu().numpy()[None, None], 6, 1).repeat(B, 0)
    return gj, (x0, np.zeros((B, 5, 4)), np.repeat(x0[:, None], 6, 1), z)


@pytest.mark.parametrize("formulation", ["condensed", "sparse"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gusto_locps_on_the_card(cuda_device, monkeypatch, formulation,
                                 dtype):
    """The batched ADMM launch of GuSTO's fused loop at B=64, on the LOCPs
    of its first SCP iteration (per-problem A with the trust-region rows,
    bounds of 1e30): kernel 1's block form for the condensed LOCP (n=21,
    m=641), the streaming kernel for the sparse one (n=386, m=1126), against
    the plain version, in f64 to 1e-9 and in f32 to 1e-4 (condensed) and
    1e-2 (sparse: its 1e3 equality rho and 50 iterations amplify f32
    rounding, 4.9e-3 measured on an H100) of the solution's scale (1e3 to
    1e4: cable forces and their duals)."""
    gj, args = _gusto(cuda_device, dtype, formulation, 64)
    seen = []
    real = gusto_jit.admm_batched

    def record(*a):
        seen.append([t.clone() for t in a[:8]] + [a[8]])
        return real(*a)

    monkeypatch.setattr(gusto_jit, "admm_batched", record)
    admm_batched.launches = admm_stream.launches = 0
    gj.solve_batch_fused(*args)
    kernel = admm_batched if formulation == "condensed" else admm_stream
    assert kernel.launches == 5
    ka, iters = seen[0][:8], seen[0][8]
    assert tuple(ka[1].shape) == ((64, 641, 21) if formulation == "condensed"
                                  else (64, 1126, 386))
    got = kernel(*ka, iters)
    ref = admm_batched_plain(*ka, iters)
    torch.cuda.synchronize()
    scale = max(max(float(b.abs().max()) for b in ref), 1.0)
    tol = scale * (1e-9 if dtype == torch.float64 else
                   1e-4 if formulation == "condensed" else 1e-2)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("formulation", ["condensed", "sparse"])
def test_gusto_fused_on_the_card_matches_the_cpu(cuda_device, formulation):
    """solve_batch_fused in f64 on the card against the same call on the
    CPU: identical iteration counts and flags, x and u to 1e-6 of their
    scale; one ADMM launch and two select launches an SCP iteration."""
    gj, args = _gusto(cuda_device, torch.float64, formulation, 4)
    admm_batched.launches = admm_stream.launches = tpwl_select.launches = 0
    got = gj.solve_batch_fused(*args)
    assert (admm_batched.launches + admm_stream.launches,
            tpwl_select.launches) == (5, 10)
    ref = _gusto("cpu", torch.float64, formulation, 4)[0].solve_batch_fused(
        *args)
    assert torch.equal(got.iters.cpu(), ref.iters)
    assert torch.equal(got.converged.cpu(), ref.converged)
    for k in ("x", "u"):
        r = getattr(ref, k)
        d = float((getattr(got, k).cpu() - r).abs().max())
        assert d <= 1e-6 * max(float(r.abs().max()), 1.0)


def _ssm_mpc(name, formulation, dtype, dev):
    """bench.py section 5's BatchSSMMPC (N=3, dt=0.02, N_replan=2, 50 ADMM
    iterations, Qz on the tip's x and y, R = 1e-6 I) on an SSM artifact."""
    model = from_mat(SSM_ARTIFACTS[name], None, discrete=False,
                     discr_method="be", device=dev)
    Qz = np.zeros((6, 6))
    Qz[0, 0] = Qz[1, 1] = 100.0
    return BatchSSMMPC(model, Qz, 1e-6 * np.eye(model.input_dim), N=3,
                       dt=0.02, N_replan=2, qp_iters=50,
                       formulation=formulation, dtype=dtype, device=dev)


@pytest.fixture(scope="module")
def ssm_qps():
    """The batched ADMM launch of each BatchSSMMPC window, f64 at B=1024,
    captured in the second window of build_fused (the plans then differ
    from loop to loop), keyed by (artifact, formulation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    out = {}
    real = batch_mpc.admm_batched
    for name in ("trunk", "diamond"):
        for formulation in ("condensed", "sparse"):
            mpc = _ssm_mpc(name, formulation, torch.float64, "cuda")
            seen = []

            def record(*a):
                seen.append([t.clone() for t in a[:8]] + [a[8]])
                return real(*a)

            batch_mpc.admm_batched = record
            try:
                mpc.build_fused(2)(np.zeros((1024, 6)),
                                   ssm_targets(1024, 2))
            finally:
                batch_mpc.admm_batched = real
            assert len(seen) == 2
            out[name, formulation] = seen[1]
    return out


def _f32_error_ratio(args, iters):
    """The kernel's f32 result against the plain version in f64 on the
    same f32 inputs, over the plain f32 result's error against the same."""
    exact = admm_batched_plain(*[t.double() for t in args], iters)
    errs = []
    for r in (admm_batched(*args, iters), admm_batched_plain(*args, iters)):
        errs.append(max(float((a.double() - b).abs().max())
                        for a, b in zip(r, exact)))
    return errs[0], errs[1]


@pytest.mark.parametrize("name,formulation,n,m", [
    ("trunk", "condensed", 24, 1), ("diamond", "condensed", 12, 1),
    ("trunk", "sparse", 48, 24), ("diamond", "sparse", 36, 24)])
@pytest.mark.parametrize("B", [1, 3, 1024])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_admm_kernel_on_ssm_locps(ssm_qps, name, formulation, n, m, B,
                                  dtype):
    """Kernel 1 on the LOCPs that BatchSSMMPC assembles: the condensed
    ones (one vacuous row with bounds of 1e30; in f32 the register form,
    padded to n=24, m=48) and the sparse ones (the block form; the init
    and dynamics rows with the 1e3 rho boost), against the plain version.
    f64: to 1e-9 of the solution's scale. f32: the kernel's error against
    the plain version in f64 on the same inputs within 2x the plain f32
    version's, and the kernel within the larger of 1e-4 of the scale and
    twice that plain error of the plain f32 version (the Diamond's LOCPs,
    K^-1 entries to 1.8e5 with R = 1e-6 I, put the plain version's own
    f32 error near 1e-4 of the scale and above it; chip_smoke.py states
    the measurements)."""
    qp = ssm_qps[name, formulation]
    ka, iters = qp[:8], qp[8]
    args = [t.to(dtype) for t in ka]
    args = [t[:B] if t.dim() > 1 else t for t in args]
    assert tuple(args[1].shape) == (B, m, n) and iters == 50
    assert batched_form(n, m, args[0].element_size()) == (
        "registers" if dtype == torch.float32 and m == 1 else "block")
    launches = admm_batched.launches
    got = admm_batched(*args, iters)
    ref = admm_batched_plain(*args, iters)
    torch.cuda.synchronize()
    assert admm_batched.launches == launches + 1
    scale = max(max(float(b.abs().max()) for b in ref), 1.0)
    tol = 1e-9 * scale
    if dtype == torch.float32:
        e_k, e_p = _f32_error_ratio(args, iters)
        assert e_k <= 2.0 * e_p
        tol = max(1e-4 * scale, 2.0 * e_p)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("n", [24, 12])
@pytest.mark.parametrize("B", [1, 3, 1024])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_admm_kernel_one_row_with_infinite_bounds(cuda_device, n, B, dtype,
                                                  tol):
    """Random QPs of one row with l = -inf and u = +inf (the padded rows of
    the register form must stay inert, and the clip must pass the infinite
    bounds through)."""
    args = _qps(B, n, 1, seed=n + B)
    args[3][:] = -np.inf
    args[4][:] = np.inf
    args = [t.to(cuda_device, dtype) for t in args]
    got = admm_batched(*args, 50)
    ref = admm_batched_plain(*args, 50)
    torch.cuda.synchronize()
    _assert_close(got, ref, dtype, tol)


@pytest.mark.parametrize("name", ["trunk", "diamond"])
@pytest.mark.parametrize("formulation", ["condensed", "sparse"])
def test_ssm_mpc_on_the_card_matches_the_cpu(cuda_device, name,
                                             formulation):
    """build_fused at B=64 for 3 windows: one launch of kernel 1 a window
    and none of the others; the f64 loop on the card agrees with the f64
    loop on the CPU to 1e-9 of the logs' scale (outputs about z_ref), and
    the f32 loop's logs are finite."""
    zt, x0 = ssm_targets(64, 3), np.zeros((64, 6))
    logs = {}
    for dev, dt in ((cuda_device, torch.float64), ("cpu", torch.float64),
                    (cuda_device, torch.float32)):
        mpc = _ssm_mpc(name, formulation, dt, dev)
        admm_batched.launches = admm_cluster.launches = 0
        admm_stream.launches = admm_single.launches = 0
        tpwl_select.launches = 0
        out = mpc.build_fused(3)(x0, zt)
        counts = (admm_batched.launches, admm_cluster.launches,
                  admm_stream.launches, admm_single.launches,
                  tpwl_select.launches)
        assert counts == ((3 if dev != "cpu" else 0), 0, 0, 0, 0)
        z_ref = mpc.model.z_ref.double().cpu().numpy()
        logs[str(dev), dt] = (out["z"].double().cpu().numpy() - z_ref,
                              out["u"].double().cpu().numpy())
    for got, ref in zip(logs[str(cuda_device), torch.float64],
                        logs["cpu", torch.float64]):
        assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()
    assert all(np.isfinite(a).all()
               for a in logs[str(cuda_device), torch.float32])


@pytest.mark.parametrize("n,m", [(40, 152), (80, 1)])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_admm_kernel_at_the_baselines_shapes(cuda_device, n, m, B, dtype,
                                             tol):
    """Kernel 1 at the shapes of the LTI baselines' QPs: Koopman MPC's
    condensed LOCP (N=10 steps of 4 cables: n=40, and m=152 rows of the
    U and dU boxes) and ROMPC's (n=80, no constraint: the one placeholder
    row), 100 iterations."""
    args = [t.to(cuda_device, dtype) for t in _qps(B, n, m, seed=n + m,
                                                   inf_rows=m // 8)]
    launches = admm_batched.launches
    got = admm_batched(*args, 100)
    ref = admm_batched_plain(*args, 100)
    torch.cuda.synchronize()
    assert admm_batched.launches == launches + 1
    _assert_close(got, ref, dtype, tol)


@pytest.mark.parametrize("kkt_solver", ["cr", "scan"])
@pytest.mark.parametrize("trust_region", [False, True])
def test_stage_locp_on_the_card_matches_the_cpu(cuda_device, kkt_solver,
                                                trust_region):
    """StageLOCP at bench.py section 4b's settings (the campaign
    dictionary's first discrete point repeated, Qz = 100 I, R = 1e-3 I,
    cables in [0, 1500]) at N=64, 100 ADMM iterations, in f64 on the card
    against the CPU: w within 1e-8 of its scale (measured on an H100
    80GB HBM3: 1.1e-9 with 'cr', whose block inverses pass the 1e3
    equality rho's amplification on, 1e-11 with 'scan'); no kernel
    launches."""
    from soft_robot_control_tpu_torch.scp.locp_stages import StageLOCP

    N = 64
    d = campaign_dict([0])
    H = campaign_output_maps()[1]
    model = from_tpwl_dict(d, params=CAMPAIGN_PARAMS, Hf=H, device="cpu")
    rep = lambda a: np.repeat(np.asarray(a, np.float64), N, axis=0)
    rng = np.random.default_rng(3)
    args = (rep(d["A_d"]), rep(d["B_d"]), rep(d["d_d"]), np.zeros(60),
            0.05 * rng.normal(size=(N + 1, 3)))
    kw = {}
    if trust_region:
        kw = dict(delta=5.0, omega=1.0, xk=0.1 * rng.normal(size=(N + 1, 60)))
    out = {}
    for dev in (cuda_device, "cpu"):
        st = StageLOCP(N, model.H.cpu().numpy(), 100.0 * np.eye(3),
                       1e-3 * np.eye(4),
                       U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
                       trust_region=trust_region, kkt_solver=kkt_solver,
                       device=dev)
        admm_batched.launches = tpwl_select.launches = 0
        out[str(dev)] = st.solve(*args, iters=100, **kw)[0].cpu().numpy()
        assert admm_batched.launches == tpwl_select.launches == 0
    ref = out["cpu"]
    assert np.abs(out[str(cuda_device)] - ref).max() <= \
        1e-8 * max(np.abs(ref).max(), 1.0)


def test_golden_closed_loop_on_the_card(cuda_device):
    """The golden closed loop (tests/test_golden.py's settings on the
    committed chain fixture) in f64 on the card: z and u meet
    tests/golden/closed_loop_chain.npz at the golden test's tolerances,
    through kernel 2 and no other kernel."""
    for w in (admm_batched, tpwl_select, admm_stream, admm_cluster,
              admm_single):
        w.launches = 0
    z, u, _ = golden_loop(cuda_device)
    assert tpwl_select.launches > 0
    assert admm_batched.launches == admm_stream.launches == 0
    assert admm_cluster.launches == admm_single.launches == 0
    ref = np.load(GOLDEN_CHAIN)
    np.testing.assert_allclose(z, ref["z"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(u, ref["u"], rtol=1e-5, atol=1e-8)


def test_campaign_scp_on_the_card_matches_the_cpu(cuda_device):
    """The campaign's real-time scp controller (torch_helpers.campaign_scp)
    at N=5 on a 64-point subset of the dictionary at full width, the
    lifted dictionary as the plant, a 2-tick delay then 8 ticks, in f64 on
    the card and on the CPU: logged z and u within 1e-6 of their scale;
    kernel 2 launched on the card."""
    Cf, Hf = campaign_output_maps()
    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    out = {}
    for dev in (cuda_device, "cpu"):
        model = from_tpwl_dict(data, params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf,
                               discr_method="be", device=dev)
        tpwl_select.launches = 0
        sim = run_closed_loop(
            LiftedPlant(model), campaign_scp(model, N=5), 0.1, 0.01,
            measurement_model=TLin(Cf, dev), output_model=TLin(Hf, dev),
            u_limits=(np.zeros(4), 1500.0 * np.ones(4)))
        out[str(dev)] = (sim["z"], sim["u"], tpwl_select.launches)
    card, cpu = out[str(cuda_device)], out["cpu"]
    assert card[2] > 0 and cpu[2] == 0
    for got, ref in zip(card[:2], cpu[:2]):
        assert np.abs(got - ref).max() <= 1e-6 * max(np.abs(ref).max(), 1.0)


def test_tet_plant_on_the_card_matches_the_cpu(cuda_device):
    """tests/test_fem_tet.py:51-61's box plant built on the card in f64 and
    carried to the CPU (models/convert.py): 10 steps under seeded inputs
    (the same PCG iterations) and reduced_discrete_dynamics at the last
    state within 1e-9 of their scale."""
    from soft_robot_control_tpu_torch.models.convert import (
        tet_fem_arrays, tet_fem_from_arrays)
    from soft_robot_control_tpu_torch.rom.pod import POD
    from soft_robot_control_tpu_torch.sim import fem_tet
    from tet_box import box_plant

    card = box_plant(fem_tet, device=cuda_device)
    cpu = tet_fem_from_arrays(tet_fem_arrays(card), device="cpu")
    rng = np.random.default_rng(0)
    xs = {}
    for p in (card, cpu):
        x, its = p.x_rest(), []
        for u in 40.0 * rng.random((10, 2)):
            x, k = p.step_iters(x, torch.as_tensor(u, device=p.device),
                                p.dt)
            its.append(int(k))
        xs[p.device.type] = (x, its)
        rng = np.random.default_rng(0)
    (xc, kc), (xh, kh) = xs["cuda"], xs["cpu"]
    assert kc == kh
    scale = float(xh.abs().max())
    assert float((xc.cpu() - xh).abs().max()) <= 1e-9 * scale
    U, _ = np.linalg.qr(rng.normal(size=(card.n_nodes_dof, 4)))
    info = {"U": U, "q_ref": card.q_eq.cpu().numpy(),
            "v_ref": np.zeros(card.n_nodes_dof)}
    u = torch.tensor([30.0, 10.0], dtype=torch.float64)
    got = card.reduced_discrete_dynamics(POD(info, device=cuda_device),
                                         xc, u.to(cuda_device), card.dt)
    ref = cpu.reduced_discrete_dynamics(POD(info, device="cpu"), xh, u,
                                        cpu.dt)
    for g, r in zip(got, ref):
        assert float((g.cpu() - r).abs().max()) <= 1e-9 * float(
            r.abs().max())


def test_block_time_waits_for_the_card(cuda_device):
    """utils/timing.py:block_time of a call that queues about 50 ms of
    sleep on the card and then a product: it returns only after the card
    has finished (the output's event has completed), and its time is at
    least what CUDA events read for the same call (less 1 ms), and not
    more than 50 ms above it."""
    from soft_robot_control_tpu_torch.utils.timing import block_time

    a = torch.ones(256, 256, dtype=torch.float64, device=cuda_device)
    done = []

    def call():
        torch.cuda._sleep(100_000_000)
        out = a @ a
        ev = torch.cuda.Event()
        ev.record()
        done.append(ev)
        return {"out": [out]}

    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    ev_ms = start.elapsed_time(end)
    s = block_time(call)
    assert done[-1].query()
    assert ev_ms > 10.0
    assert ev_ms - 1.0 <= 1e3 * s <= ev_ms + 50.0


@pytest.mark.parametrize("recipe", ["rompc", "koopman"])
def test_lti_recipes_on_the_card_match_the_cpu(cuda_device, tmp_path,
                                               recipe):
    """tasks/recipes.py:run_rompc and run_koopman with the condensed LOCP
    and the batched ADMM kernel ('pallas') on the Diamond surrogate of 10
    nodes, its dictionary built on the CPU at tests/test_recipes.py's
    settings: the first replans (0.3 s after a 0.2 s delay; Koopman on 16
    LHS samples of EDMD data) in f64 on the card and on the CPU, z and u
    within 1e-6 of their scale; kernel 1 launched on the card only. The
    closed loop hands the controllers their measurements on the card."""
    from soft_robot_control_tpu_torch.robots import DiamondRobot
    from soft_robot_control_tpu_torch.tasks import recipes

    def robot(dev):
        r = DiamondRobot(n_nodes=10, seed=0, device=dev)
        r.dt = r.sequences.dt = 0.02
        return r

    d = str(tmp_path)
    cpu = robot("cpu")
    recipes.collect_pod_data(cpu, d, nbr_samples=15, t_step=0.3, seed=1)
    recipes.compute_pod_basis(d, pod_tolerance=1e-8, pod_type="v")
    recipes.collect_tpwl_data(cpu, d, threshold=0.4, nbr_samples=15, seed=2)
    Hf = cpu.get_output_model()
    z0 = float((cpu.plant.x_rest().numpy() @ Hf.T)[0])
    tt = 0.02 * np.arange(300)
    zt = z0 + 0.05 * np.sin(2 * np.pi * tt / 4.0)[:, None]
    kw = dict(sim_duration=0.3, delay=0.2, locp_backend="condensed",
              qp_backend="pallas")
    out = {}
    for dev, r in ((cuda_device, robot(cuda_device)), ("cpu", cpu)):
        admm_batched.launches = 0
        prefix = f"{recipe}_{str(dev)[:4]}"
        if recipe == "rompc":
            sim = recipes.run_rompc(r, d, tt, zt, N=20, N_replan=4,
                                    Qz=np.array([[100.0]]),
                                    R=1e-4 * np.eye(4), save_prefix=prefix,
                                    **kw)
        else:
            sim = recipes.run_koopman(r, d, tt, zt, delay_embed=1, degree=2,
                                      N=10, rollout_horizon=4,
                                      nbr_samples=16, absolute_targets=True,
                                      save_prefix=prefix, **kw)
        out[str(dev)] = (sim["z"], sim["u"], admm_batched.launches)
    card, ref = out[str(cuda_device)], out["cpu"]
    assert card[2] > 0 and ref[2] == 0
    for got, want in zip(card[:2], ref[:2]):
        assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(),
                                                       1.0)
