"""The batch-fused MPC loop's CUDA graphs on the card (control/batch_mpc.py
`StageGraphs`): the QP build's and the ticks' stage bodies captured in the
second call at a batch size and replayed from then on give the bits of the
same bodies run as they are, call after call, spans on or off.

These tests import neither JAX nor the JAX package; they run on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_graphs_cuda.py -q --noconftest

Without a card every test here skips. On a made-up dictionary of the
Diamond's widths (r=30, 4 cables, 5 measured nodes, one output node), in
float32 with TF32 off, as the benchmark's configuration runs."""

import numpy as np
import pytest
import torch

from torch_helpers import cuda_device, made_up_tpwl  # noqa: F401

from soft_robot_control_tpu_torch.control.batch_mpc import (BatchMPC,
                                                            StageGraphs)
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.estimators.ekf import EKFState, ekf_correct
from soft_robot_control_tpu_torch.qp.blocked import make_kinv
from soft_robot_control_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda

WINDOWS, N, N_REPLAN, RHO_STAGES, CABLES = 4, 5, 2, 4, 4
# stage bodies a window: assemble, Ruiz, K^-1 a rho stage, the rebalance
# between stages, recover, and a tick's body and EKF correction a tick
PER_WINDOW = 1 + 1 + RHO_STAGES + (RHO_STAGES - 1) + 1 + 2 * N_REPLAN


@pytest.fixture(autouse=True)
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _mpc(model, formulation="condensed", **kw):
    """BatchMPC at the Diamond configuration's settings (port_bench
    configs/diamond_tpwl.json) on `model`."""
    nx, ny = model.state_dim, model.C.shape[0]
    return BatchMPC(model, 100.0 * np.eye(3), 1e-5 * np.eye(CABLES), N=N,
                    dt=0.01, N_replan=N_REPLAN,
                    U=HyperRectangle(1500.0 * np.ones(CABLES),
                                     np.zeros(CABLES)),
                    qp_iters=100, rho_stages=RHO_STAGES, x_step="kinv",
                    formulation=formulation, scaling_iters=6,
                    W=1e-2 * np.eye(nx), V=1e-4 * np.eye(ny),
                    dtype=torch.float32, device=model.q.device, **kw)


def _inputs(model, B, seed, windows=WINDOWS):
    """A call's inputs: states near rest, targets near the output's
    reference, standard normal measurement noise."""
    gen = torch.Generator(device=model.q.device).manual_seed(seed)
    kw = dict(generator=gen, device=model.q.device, dtype=torch.float32)
    x0 = 0.05 * torch.randn((B, model.state_dim), **kw)
    zt = model.z_ref + 0.05 * torch.randn((B, windows, N + 1, 3), **kw)
    noise = torch.randn((windows, N_REPLAN, B, model.C.shape[0]), **kw)
    return x0, x0.clone(), zt, noise


def _eager(mpc, run, args):
    """The call as the loop's first call at its batch size: every stage
    body run as it is."""
    mpc._stages.clear()
    return run(*args)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return made_up_tpwl(64, 30, CABLES, 12, [0, 2, 4, 6, 8], [1],
                        device="cuda")


@pytest.mark.parametrize("B", [64, 4096])
def test_replays_give_the_eager_bits_call_after_call(model, B):
    graphed, eager = _mpc(model), _mpc(model)
    run = graphed.build_fused(WINDOWS, noise_std=0.1)
    ref = eager.build_fused(WINDOWS, noise_std=0.1)
    calls = [_inputs(model, B, seed) for seed in range(5)]
    run(*calls[0])                       # eager: warms the libraries
    counts = []
    for args in calls[1:]:               # capture, then replays
        before = StageGraphs.replays
        got = run(*args)
        counts.append(StageGraphs.replays - before)
        want = _eager(eager, ref, args)
        for k in ("z", "u"):
            assert torch.equal(got[k], want[k]), k
        assert bool(torch.isfinite(got["z"]).all())
    assert counts == [WINDOWS * PER_WINDOW] * 4
    (runner,) = graphed._stages.values()
    assert len(runner.graphs) == 7


def test_spans_on_and_off_give_the_same_bits(model):
    mpc = _mpc(model)
    run = mpc.build_fused(WINDOWS, noise_std=0.1)
    args = _inputs(model, 256, 11)
    for _ in range(2):
        run(*args)
    off = run(*args)
    with timing.spans():
        on = run(*args)
    for k in ("z", "u"):
        assert torch.equal(off[k], on[k])


@pytest.mark.parametrize("trust_region", [False, True])
def test_the_sparse_loop_replays_give_the_eager_bits(model, trust_region):
    """The sparse formulation takes the same graphs (kernel 3's cluster
    form for its 380-variable QPs)."""
    graphed = _mpc(model, "sparse", trust_region=trust_region)
    eager = _mpc(model, "sparse", trust_region=trust_region)
    run, ref = graphed.build_fused(2), eager.build_fused(2)
    calls = [_inputs(model, 8, seed, windows=2)[:3] for seed in range(4)]
    run(*calls[0])
    for args in calls[1:]:
        got, want = run(*args), _eager(eager, ref, args)
        for k in ("z", "u"):
            assert torch.equal(got[k], want[k]), k


def test_the_card_sets_the_flag_of_a_failed_factorization(model):
    """make_kinv's and ekf_correct's cholesky_ex report a failure of one
    problem of a batch on the card, inside a graph too."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, n, m = 64, 20, 40
    Ph = torch.randn((B, n, n), generator=gen, device="cuda")
    P = Ph @ Ph.transpose(1, 2) + 0.1 * torch.eye(n, device="cuda")
    # indefinite with a positive diagonal: K is not positive definite and
    # its Jacobi scaling is finite (a NaN K sets no flag, here as in
    # torch.linalg.cholesky)
    P[5] = 10.0 * (2.0 * torch.eye(n, device="cuda")
                   - torch.ones((n, n), device="cuda"))
    A = torch.randn((B, m, n), generator=gen, device="cuda")
    rho = torch.full((m,), 0.1, device="cuda")
    C = torch.randn((30, 60), generator=gen, device="cuda")
    ekf_model = type("Model", (), {"C": C,
                                   "y_ref": torch.zeros(30, device="cuda")})
    Sigma = torch.eye(60, device="cuda").repeat(B, 1, 1)
    V = 1e-4 * torch.eye(30, device="cuda").repeat(B, 1, 1)
    Sigma[7] = V[7] = 0.0
    state = EKFState(torch.zeros((B, 60), device="cuda"), Sigma)
    y = torch.zeros((B, 30), device="cuda")
    for what in ("kinv", "ekf"):
        info = torch.zeros((), dtype=torch.bool, device="cuda")
        fn = ((lambda: make_kinv(P, A, rho, info=info)) if what == "kinv"
              else (lambda: ekf_correct(ekf_model, state, y, V, info=info)))
        fn()
        assert bool(info), what
        info.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        assert bool(info), what


@pytest.mark.parametrize("B,ny", [(64, 30), (4096, 30), (4096, 18)])
def test_the_deferred_checks_on_the_card(cuda_device, B, ny):
    """make_kinv with `info` runs the default's factorization (cuSOLVER's
    batched Cholesky, cuBLAS's batched triangular solves) without the host
    read: the same bits, captured in a graph too. ekf_correct with `info`
    solves through a Cholesky factor, the default through MAGMA's batched
    LU: the same bits eager and in a graph, and each within 8 n_y cond(S)
    eps of the float64 update of the same float32 inputs, in the largest
    entry's scale (both backward stable). At the Diamond's and the Trunk's
    measurement sizes, from a settled covariance and V = 1e-4 I as the
    configurations set."""
    gen = torch.Generator(device="cuda").manual_seed(ny)
    kw = dict(generator=gen, device="cuda")
    C = torch.randn((ny, 60), **kw)
    L = 0.3 * torch.randn((B, 60, 60), **kw)
    Sigma = L @ L.transpose(1, 2) + 1e-2 * torch.eye(60, device="cuda")
    V = 1e-4 * torch.eye(ny, device="cuda")
    ekf_model = type("Model", (), {"C": C,
                                   "y_ref": torch.zeros(ny, device="cuda")})
    state = EKFState(torch.randn((B, 60), **kw), Sigma)
    y = torch.randn((B, ny), **kw)
    Ph = torch.randn((B, 20, 20), **kw)
    P = Ph @ Ph.transpose(1, 2) + 0.1 * torch.eye(20, device="cuda")
    A = torch.randn((B, 40, 20), **kw)
    rho = torch.full((40,), 0.1, device="cuda")
    info = torch.zeros((), dtype=torch.bool, device="cuda")
    deferred = lambda: (make_kinv(P, A, rho, info=info),
                        *ekf_correct(ekf_model, state, y, V, info=info))
    now = (make_kinv(P, A, rho), *ekf_correct(ekf_model, state, y, V))
    eager = deferred()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = deferred()
    graph.replay()
    assert not bool(info)
    assert torch.equal(now[0], eager[0]) and torch.equal(now[0], out[0])
    for a, b in zip(eager[1:], out[1:]):
        assert torch.equal(a, b)
    f64 = ekf_correct(
        type("Model", (), {"C": C.double(), "y_ref": torch.zeros(
            ny, dtype=torch.float64, device="cuda")}),
        EKFState(state.x.double(), Sigma.double()), y.double(), V.double())
    S = C.double() @ Sigma.double() @ C.double().T + V.double()
    tol = 8 * ny * float(torch.linalg.cond(S).max()) * 2.0 ** -23
    for d, n, r in zip(eager[1:], now[1:], f64):
        err_d = float((d.double() - r).abs().max())
        err_n = float((n.double() - r).abs().max())
        scale = float(r.abs().max())
        print(f"B={B} n_y={ny}: deferred {err_d:.3e}, default {err_n:.3e}, "
              f"scale {scale:.3e}, bound {tol * scale:.3e}")
        assert err_d <= tol * scale and err_n <= tol * scale
