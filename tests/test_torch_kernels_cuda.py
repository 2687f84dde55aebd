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

from torch_helpers import (CAMPAIGN_PARAMS, campaign_dict,  # noqa: F401
                           campaign_output_maps, cuda_device)

from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
from soft_robot_control_tpu_torch.ops import build
from soft_robot_control_tpu_torch.ops.admm_batched import (
    PLAN_FIELDS, _SIGNATURES, admm_batched, admm_batched_plain, admm_cluster,
    admm_stream, batched_form, cluster_max_active, cluster_plan,
    cluster_plan_built, kernel_for, qp_bytes)
from soft_robot_control_tpu_torch.ops.admm_single import (admm_single,
                                                          admm_single_plain,
                                                          prepare_single,
                                                          single_plan_built)
from soft_robot_control_tpu_torch.ops.tpwl_select import (
    point_distances_batch, tpwl_select, tpwl_select_plain)
from soft_robot_control_tpu_torch.qp.blocked import make_kinv
from soft_robot_control_tpu_torch.scp import gusto_jit
from soft_robot_control_tpu_torch.scp.gusto_jit import GuSTOJit

pytestmark = pytest.mark.cuda


def _qps(B, n, m, seed, inf_rows=0):
    """Random feasible QPs with K^-1 from the port's make_kinv (f64); the
    first `inf_rows` rows have no lower bound, the next as many no upper."""
    rng = np.random.default_rng(seed)
    Ph = rng.normal(size=(B, n, n))
    P = torch.as_tensor(Ph @ Ph.transpose(0, 2, 1) + 0.1 * np.eye(n))
    A = rng.normal(size=(B, m, n))
    mid = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.2)
    rho = torch.full((m,), 0.1, dtype=torch.float64)
    A = torch.as_tensor(A)
    Kinv = make_kinv(P, A, rho)
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
    at a ragged smaller one) and its shared form (f64, past 32 variables,
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
                                   (5, 12, 16), (2, 70, 33),
                                   (64, 386, 1126)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_stream_kernel_matches_plain(cuda_device, B, n, m, dtype, tol):
    """Kernel 3 at the sparse LOCP's size, at GuSTO's sparse LOCP's (n=386,
    not a multiple of 4, m=1126) and at sizes that exercise its
    thread-group layout (several column groups, ragged warps), with
    infinite bounds."""
    args = [t.to(cuda_device, dtype) for t in _qps(B, n, m, seed=n,
                                                   inf_rows=m // 8)]
    launches = admm_stream.launches
    got = admm_stream(*args, 25)
    ref = admm_batched_plain(*args, 25)
    torch.cuda.synchronize()
    assert admm_stream.launches == launches + 1
    _assert_close(got, ref, dtype, tol)


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
    shifted = []
    for t in args:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        shifted.append(buf[1:].view(t.shape))
    assert shifted[0].data_ptr() % 16 == 4
    strided = [args[0].transpose(1, 2).contiguous().transpose(1, 2)] + args[1:]
    for a in (shifted, strided):
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
                   (24, 49), (32, 65), (33, 64)):
        assert lib.admm_batched_form(nn, mm, elem) == (
            batched_form(nn, mm, elem) == "registers")
    for R in (0, 1, 6, 8):
        want = cluster_plan(n, m, elem, R or None)
        got = cluster_plan_built(n, m, elem, R)
        assert (got is None) == (want is None)
        if got is not None:
            assert got == {k: want[k] for k in PLAN_FIELDS}
            assert 1 <= cluster_max_active(n, m, elem, R) <= 132
    want = cluster_plan(n, m, elem, single=True)
    assert single_plan_built(n, m, elem) == {k: want[k] for k in PLAN_FIELDS}


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
    bounds of 1e30): kernel 1's shared form for the condensed LOCP (n=21,
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
