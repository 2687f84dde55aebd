"""The cluster-resident ADMM kernels' decomposition and plan, on the CPU.

The CUDA kernels csrc/admm_cluster.cu (K^-1 form) and csrc/admm_single.cu
(M1 form) cut one QP's rows into R slices, one per block of a thread-block
cluster, and exchange per-slice partial sums. `emulate` below repeats that
arithmetic in PyTorch: the slices of `row_slices`, partials per slice, sums
in rank order, K^-1's symmetry for the x-step. It is held in f64 to the
kernels' plain versions and through them to the JAX package, so that a wrong
slice or a wrong use of the symmetry shows before any card is involved. It
is a test aid: nothing in the port calls it. The plan (`cluster_plan`,
`kernel_for`) is what the wrappers and the .cu sources lay a QP out by; the
card tests hold it to what the built sources export."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.control.batch_mpc import admm_fixed as jax_fixed
from soft_robot_control_tpu.ops.pallas_admm import _admm_batched_pallas_grid
from soft_robot_control_tpu_torch.ops.admm_batched import (
    _SMEM_LIMIT, admm_batched, admm_batched_plain, admm_cluster,
    cluster_plan, kernel_for, qp_bytes, rhs_window, row_slices,
    usable_cluster)
from soft_robot_control_tpu_torch.ops.admm_single import (admm_single_plain,
                                                          prepare_single)
from soft_robot_control_tpu_torch.qp.blocked import make_kinv


def emulate(form, K, A, q, l, u, rho, w0, y0, iters, R, sigma=1e-6,
            alpha=1.6):
    """One QP as a cluster of (at most) R blocks computes it: K is K^-1
    ('kinv', symmetric) or M1 ('m1'); block r holds rows a[r] of A, l, u,
    z, y, rho and rows k[r] of K; w, rhs and x~ are replicated."""
    n, m = q.shape[0], l.shape[0]
    R = usable_cluster(n, R)
    a, k = row_slices(m, R), row_slices(n, R)

    def rank_sum(parts):
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    w = w0
    z = [torch.clamp(A[lo:hi] @ w, l[lo:hi], u[lo:hi]) for lo, hi in a]
    y = [y0[lo:hi] for lo, hi in a]
    for _ in range(iters):
        t = [rho[lo:hi] * z[r] - y[r] for r, (lo, hi) in enumerate(a)]
        rhs = sigma * w - q + rank_sum(
            [A[lo:hi].T @ t[r] for r, (lo, hi) in enumerate(a)])
        if form == "kinv":  # K symmetric: K rhs = sum_r K[rows_r]' rhs[rows_r]
            x = rank_sum([K[lo:hi].T @ rhs[lo:hi] for lo, hi in k])
        else:               # M1' (M1 rhs), s needed at the block's rows only
            x = rank_sum([K[lo:hi].T @ (K[lo:hi] @ rhs) for lo, hi in k])
        w = alpha * x + (1 - alpha) * w
        for r, (lo, hi) in enumerate(a):
            z_rel = alpha * (A[lo:hi] @ x) + (1 - alpha) * z[r]
            z_new = torch.clamp(z_rel + y[r] / rho[lo:hi], l[lo:hi], u[lo:hi])
            y[r] = y[r] + rho[lo:hi] * (z_rel - z_new)
            z[r] = z_new
    return w, torch.cat(y)


def _qp(n, m, seed, eq_rows=0, inf_rows=0):
    """(P, q, A, l, u, rho, w0, y0) of one feasible QP: `eq_rows` equality
    rows with a boosted rho, then `inf_rows` rows without a lower bound and
    as many without an upper one."""
    rng = np.random.default_rng(seed)
    Ph = rng.normal(size=(n, n))
    P = Ph @ Ph.T + 0.1 * np.eye(n)
    A = rng.normal(size=(m, n))
    mid = A @ (0.2 * rng.normal(size=n))
    l = mid - rng.uniform(0.1, 1, m)
    u = mid + rng.uniform(0.1, 1, m)
    l[:eq_rows] = u[:eq_rows]
    l[eq_rows:eq_rows + inf_rows] = -np.inf
    u[eq_rows + inf_rows:eq_rows + 2 * inf_rows] = np.inf
    rho = 0.1 * np.ones(m)
    rho[:eq_rows] *= 1000
    return [torch.as_tensor(t) for t in (
        P, rng.normal(size=n), A, l, u, rho, 0.1 * rng.normal(size=n),
        0.1 * rng.normal(size=m))]


# the sparse LOCP's size, GuSTO's sparse LOCP's (the streaming kernel's,
# on 8 blocks), ragged sizes, and fewer rows than blocks (of A at (16, 5),
# of both at (5, 7), where the cluster shrinks to 5 blocks)
SIZES = [(380, 400), (386, 1126), (70, 33), (131, 77), (16, 5), (5, 7)]


@pytest.mark.parametrize("R", [1, 6, 8])
@pytest.mark.parametrize("n,m", SIZES)
def test_kinv_decomposition_matches_plain(n, m, R):
    """K^-1 form, rho shared and folded as the fused loop passes it, rows
    with infinite bounds: 1e-10 against admm_batched_plain."""
    P, q, A, l, u, rho, w0, y0 = _qp(n, m, seed=n + R, inf_rows=m // 8)
    rho = torch.full_like(rho, 0.1)
    Kinv = make_kinv(P[None], A[None], rho)[0]
    w1, y1 = emulate("kinv", Kinv, A, q, l, u, rho, w0, y0, 25, R)
    w2, y2 = admm_batched_plain(Kinv[None], A[None], q[None], l[None],
                                u[None], rho, w0[None], y0[None], 25)
    assert torch.isfinite(w1).all() and torch.isfinite(y1).all()
    np.testing.assert_allclose(w1.numpy(), w2[0].numpy(), atol=1e-10)
    np.testing.assert_allclose(y1.numpy(), y2[0].numpy(), atol=1e-10)


@pytest.mark.parametrize("R", [1, 6, 8])
@pytest.mark.parametrize("n,m", SIZES)
def test_m1_decomposition_matches_plain(n, m, R):
    """M1 form, per-row rho with boosted equality rows, infinite bounds
    clamped by the wrapper's own preparation: 1e-10 against
    admm_single_plain."""
    P, q, A, l, u, rho, w0, y0 = _qp(n, m, seed=n + R, eq_rows=m // 10,
                                     inf_rows=m // 8)
    M1, l_f, u_f = prepare_single(P, A, l, u, rho)
    w1, y1 = emulate("m1", M1, A, q, l_f, u_f, rho, w0, y0, 50, R)
    w2, y2 = admm_single_plain(M1, A, q, l_f, u_f, rho, w0, y0, 50)
    np.testing.assert_allclose(w1.numpy(), w2.numpy(), atol=1e-10)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-10)


@pytest.mark.parametrize("n,m,R", [(130, 140, 6), (60, 200, 8), (30, 40, 3)])
def test_kinv_decomposition_matches_pallas_grid(n, m, R):
    """The decomposition against the JAX package's per-QP grid kernel in
    interpret mode, 1e-10, with infinite bounds."""
    P, q, A, l, u, rho, w0, y0 = _qp(n, m, seed=n, inf_rows=10)
    rho = torch.full_like(rho, 0.1)
    Kinv = make_kinv(P[None], A[None], rho)
    args = (Kinv, A[None], q[None], l[None], u[None], rho, w0[None],
            y0[None])
    wj, yj = _admm_batched_pallas_grid(
        *[jnp.asarray(t.numpy()) for t in args], 60, interpret=True)
    w, y = emulate("kinv", Kinv[0], A, q, l, u, rho, w0, y0, 60, R)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj)[0], atol=1e-10)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj)[0], atol=1e-10)


@pytest.mark.parametrize("n,m,R", [(30, 40, 8), (70, 33, 6), (16, 5, 8)])
def test_m1_decomposition_matches_the_jax_cholesky_solver(n, m, R):
    """K^-1 = M1' M1 exactly, so the M1 decomposition equals the JAX
    package's Cholesky-solve iteration `admm_fixed`: 1e-9 on (w, y)."""
    P, q, A, l, u, rho, w0, y0 = _qp(n, m, seed=m, eq_rows=m // 8,
                                     inf_rows=m // 8)
    M1, l_f, u_f = prepare_single(P, A, l, u, rho)
    w, y = emulate("m1", M1, A, q, l_f, u_f, rho, w0, y0, 120, R)
    wj, yj = jax_fixed(*[jnp.asarray(t.numpy()) for t in (
        P, q, A, l, u, w0, y0, rho)], 120)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=1e-9)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-9)


def test_a_wrong_slice_or_missing_symmetry_shows():
    """The check has teeth: an unsymmetric K^-1 breaks the column form."""
    P, q, A, l, u, rho, w0, y0 = _qp(24, 30, seed=3)
    Kinv = make_kinv(P[None], A[None], rho)[0]
    skew = Kinv + 0.01 * torch.triu(torch.ones_like(Kinv), 1)
    ref = admm_batched_plain(skew[None], A[None], q[None], l[None], u[None],
                             rho, w0[None], y0[None], 10)[0][0]
    got = emulate("kinv", skew, A, q, l, u, rho, w0, y0, 10, 4)[0]
    assert float((got - ref).abs().max()) > 1e-6


@pytest.mark.parametrize("rows", [400, 380, 67, 33, 8, 7, 5, 1])
@pytest.mark.parametrize("R", [1, 2, 3, 5, 6, 7, 8])
def test_row_slices_cover_every_row_once(rows, R):
    slices = row_slices(rows, R)
    assert len(slices) == R
    assert [i for lo, hi in slices for i in range(lo, hi)] == list(
        range(rows))
    assert max(hi - lo for lo, hi in slices) == -(-rows // R)


@pytest.mark.parametrize("n", [1, 5, 9, 16, 50, 380])
@pytest.mark.parametrize("R", [1, 4, 6, 8])
def test_usable_cluster_gives_every_block_a_row(n, R):
    """The kernels' exchange needs every block to own a row of K^-1."""
    used = usable_cluster(n, R)
    assert 1 <= used <= R
    assert all(hi > lo for lo, hi in row_slices(n, used))
    assert used == R or not all(
        hi > lo for lo, hi in row_slices(n, used + 1))


@pytest.mark.parametrize("n,m,elem,kernel,R", [
    (20, 40, 4, "admm_batched", 1), (20, 40, 8, "admm_batched", 1),
    (380, 400, 4, "admm_cluster", 6), (252, 264, 8, "admm_cluster", 6),
    (200, 400, 8, "admm_cluster", 5), (380, 400, 8, "admm_stream", None),
    (1000, 1000, 4, "admm_stream", None)])
def test_kernel_for_picks_by_size_and_type(n, m, elem, kernel, R):
    """The condensed LOCP goes to the warp-per-QP kernel, the sparse LOCP
    in f32 to the cluster-resident one on the smallest cluster that holds
    it, in f64 (2.37 MB) to the streaming one."""
    assert kernel_for(n, m, elem) == kernel
    plan = cluster_plan(n, m, elem)
    assert (plan is None) == (R is None)
    if plan is not None:
        assert plan["R"] == R and plan["resident"]
        assert R == 1 or cluster_plan(n, m, elem, R - 1) is None
    assert (qp_bytes(n, m, elem) <= _SMEM_LIMIT) == (kernel == "admm_batched")


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("n,m", [(380, 400), (252, 264), (70, 33), (5, 7),
                                 (131, 77), (20, 40)])
@pytest.mark.parametrize("R", [None, 1, 3, 6, 8])
def test_plan_slices_and_bytes(n, m, elem, R):
    """Where a plan exists its slices are those of `row_slices`, no block
    is without a row of K^-1, its bytes count what the kernel lays out
    (the rows' region and the n-vectors padded to 16 bytes, a window's slot
    for each peer's A^T t partial) and stay within a block's 232,448."""
    plan = cluster_plan(n, m, elem, R)
    if plan is None:  # fits no cluster at all, or needs more blocks than R
        big = cluster_plan(n, m, elem, 8)
        assert big is None or (R is not None and big["R"] > R)
        return
    used = plan["R"]
    assert used <= (R or 8)
    assert plan["a_slices"] == row_slices(m, used)
    assert plan["k_slices"] == row_slices(n, used)
    assert all(hi > lo for lo, hi in plan["k_slices"])
    assert plan["V"] == (16 // elem if n % (16 // elem) == 0 else 1)
    mr, nr = plan["a_rows"], plan["k_rows"]
    assert (mr, nr) == (-(-m // used), -(-n // used))
    W = 16 // elem
    nw = -(-n // W) * W
    slot = -(-(nr + 2 * (W - 1)) // W) * W
    assert plan["rhs_slot"] == slot
    elems = (-(-(mr + nr) * n // W) * W + (6 + used) * nw + used * slot
             + 6 * mr)
    assert plan["block_bytes"] == 16 + elems * elem <= 232448
    assert (plan["a_res"], plan["k_res"]) == (mr, nr) and plan["resident"]


@pytest.mark.parametrize("n,m,elem,resident", [
    (380, 400, 4, True), (380, 400, 8, False), (252, 264, 8, True),
    (30, 40, 4, True), (5, 9, 8, True)])
def test_single_plan_is_resident_where_it_fits(n, m, elem, resident):
    """The single-QP kernel always asks for 8 blocks; f64 at the sparse
    LOCP's size is walked in place."""
    plan = cluster_plan(n, m, elem, single=True)
    assert plan["R"] == usable_cluster(n, 8)
    assert plan["resident"] == resident
    assert plan["block_bytes"] <= 232448
    assert plan["a_slices"] == row_slices(m, plan["R"])


def test_cluster_wrapper_on_cpu_runs_the_plain_version():
    P, q, A, l, u, rho, w0, y0 = _qp(12, 16, seed=0)
    rho = torch.full_like(rho, 0.1)
    args = [t[None] for t in (make_kinv(P[None], A[None], rho)[0], A, q, l,
                              u)] + [rho, w0[None], y0[None]]
    before = (admm_cluster.launches, admm_batched.launches)
    got = admm_cluster(*args, 10, cluster_size=4)
    ref = admm_batched_plain(*args, 10)
    assert (admm_cluster.launches, admm_batched.launches) == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("n", [380, 386, 131, 70, 5, 1])
@pytest.mark.parametrize("R", [1, 3, 6, 8])
def test_rhs_windows_are_aligned_and_cover_the_rows(n, R, elem):
    """The window of the A^T t partial a block receives starts and ends on
    16 bytes, holds the block's rows of K^-1, ends within the padded
    n-vector and fits the slot the plan gives each peer."""
    R = usable_cluster(n, R)
    W = 16 // elem
    slot = -(-(-(-n // R) + 2 * (W - 1)) // W) * W
    plan = cluster_plan(n, 8, elem, R)
    assert plan is None or plan["rhs_slot"] == slot
    for rank, (lo, hi) in enumerate(row_slices(n, R)):
        wlo, whi = rhs_window(n, R, rank, elem)
        assert wlo % W == 0 and whi % W == 0
        assert wlo <= lo < hi <= whi <= -(-n // W) * W
        assert whi - wlo <= slot


@pytest.mark.parametrize("n,m,elem,a_res,k_res", [
    (386, 1126, 4, 132, 0), (386, 1126, 8, 58, 0), (380, 400, 8, 50, 10),
    (380, 400, 4, 50, 48), (12, 16, 8, 3, 2)])
def test_stream_plan_keeps_rows_of_a_first(n, m, elem, a_res, k_res):
    """The streaming kernel's plan: 8 blocks (fewer where a block would own
    no row of K^-1), as many leading rows of a block's slices resident as
    the rest of its shared memory leaves room for, rows of A first (walked
    twice an iteration, K^-1 once); no row of K^-1 before every row of A."""
    plan = cluster_plan(n, m, elem, stream=True)
    assert plan["R"] == usable_cluster(n, 8)
    assert (plan["a_res"], plan["k_res"]) == (a_res, k_res)
    assert plan["k_res"] == 0 or plan["a_res"] == plan["a_rows"]
    assert plan["resident"] == (a_res == plan["a_rows"]
                                and k_res == plan["k_rows"])
    assert plan["block_bytes"] <= _SMEM_LIMIT
    nw = -(-n // (16 // elem)) * (16 // elem)
    more = plan["block_bytes"] + nw * elem  # one more resident row
    assert plan["resident"] or more > _SMEM_LIMIT


@pytest.mark.parametrize("n,m,elem,bigger", [
    (3312, 3312, 8, (3313, 3313)), (6624, 6624, 4, (6625, 6625)),
    (386, 34536, 8, (386, 34537)), (386, 73168, 4, (386, 73169))])
def test_stream_plan_ends_where_its_vectors_fill_a_block(n, m, elem, bigger):
    """The streaming kernel's limit: a QP has a plan while its vectors fit
    a block's shared memory, x~ received in windows and every row walked in
    place (n = m up to 3,312 in f64 and 6,624 in f32; m up to 34,536 and
    73,168 at GuSTO's n = 386), and none one variable and row, or one row,
    larger; the dispatch still names the streaming kernel there, whose
    launch then raises."""
    plan = cluster_plan(n, m, elem, stream=True)
    assert plan is not None and plan["block_bytes"] <= _SMEM_LIMIT
    assert (plan["a_res"], plan["k_res"]) == (0, 0) and plan["x_window"]
    assert cluster_plan(*bigger, elem, stream=True) is None
    assert kernel_for(*bigger, elem) == "admm_stream"


@pytest.mark.parametrize("n,elem", [(1842, 8), (3684, 4)])
def test_stream_plan_windows_x_only_past_the_full_slots(n, elem):
    """The streaming kernel keeps full-length slots for the peers' x~
    partials (two exchanges an iteration) while its vectors fit that way,
    up to n = m = 1,842 in f64 and 3,684 in f32, so the paths' QPs keep
    them; one variable and row more and it receives x~ in windows (a third
    exchange), with the vectors in about 8.75 n elements and three barriers
    ahead of them."""
    for shape in ((386, 1126), (380, 400), (n, n)):
        assert not cluster_plan(*shape, elem, stream=True)["x_window"]
    plan = cluster_plan(n + 1, n + 1, elem, stream=True)
    W = 16 // elem
    nw = -(-(n + 1) // W) * W
    vec = 6 * nw + 2 * 8 * plan["rhs_slot"] + 6 * plan["a_rows"]
    assert plan["x_window"] and plan["R"] == 8
    rows = plan["a_res"] + plan["k_res"]
    assert plan["block_bytes"] == 32 + (
        -(-rows * nw // W) * W + vec) * elem <= _SMEM_LIMIT
    assert vec <= 8.75 * (n + 1) + 64 * W  # the slots' 16-byte padding
