"""The batch-fused MPC loop's stage runner (control/batch_mpc.py
`StageGraphs`) and its deferred error checks, on the CPU.

`make_kinv` and `ekf_correct` raise torch.linalg.LinAlgError at once when a
factorization fails, a host read of its status each time. Given an `info`
flag they OR the failure into it on the device and read nothing (K^-1 the
same bits; the EKF's gain through a Cholesky factor in place of its LU);
the batch-fused loop reads its flag once, at the end of the call
(`StageGraphs.check`), and raises the same error type there.

On a card the runner replays each stage body as a CUDA graph, whose
outputs its next replay overwrites; here a graph is emulated (a replay
runs the body again on the graph's inputs and writes its outputs in
place), so a loop that read an output after its next replay, or fed a
graph a tensor other than its inputs, would part from the loop run as it
is. On made-up dictionaries of 8 and 16 points at B <= 8."""

import numpy as np
import pytest
import torch

from torch_helpers import made_up_tpwl

from soft_robot_control_tpu_torch.control.batch_mpc import (BatchMPC,
                                                            StageGraphs)
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.estimators.ekf import EKFState, ekf_correct
from soft_robot_control_tpu_torch.qp.blocked import make_kinv

B, N, N_REPLAN, WINDOWS, CABLES, BAD = 8, 3, 2, 2, 2, 7


def _kinv_args(dtype, bad=None):
    """A batch of B condensed-size QPs (P, A, rho); with `bad`, QP `bad`'s
    P is indefinite with a positive diagonal, so its K is not positive
    definite (and its Jacobi scaling finite)."""
    gen = torch.Generator().manual_seed(0)
    n, m = 6, 12
    Ph = torch.randn((B, n, n), generator=gen, dtype=dtype)
    P = Ph @ Ph.transpose(1, 2) + 0.1 * torch.eye(n, dtype=dtype)
    if bad is not None:
        P[bad] = 10.0 * (2.0 * torch.eye(n, dtype=dtype)
                         - torch.ones((n, n), dtype=dtype))
    A = torch.randn((B, m, n), generator=gen, dtype=dtype)
    return P, A, torch.full((m,), 0.1, dtype=dtype)


def _ekf_args(dtype, bad=None):
    """A batch of B filters (model with C, y_ref; state; y; V); with `bad`,
    filter `bad`'s innovation covariance C Sigma C' + V is zero."""
    gen = torch.Generator().manual_seed(1)
    nx, ny = 6, 4
    C = torch.randn((ny, nx), generator=gen, dtype=dtype)
    model = type("Model", (), {"C": C, "y_ref": torch.zeros(ny,
                                                            dtype=dtype)})
    L = torch.randn((B, nx, nx), generator=gen, dtype=dtype)
    Sigma = L @ L.transpose(1, 2) + torch.eye(nx, dtype=dtype)
    V = 1e-2 * torch.eye(ny, dtype=dtype).expand(B, -1, -1).clone()
    if bad is not None:
        Sigma[bad] = 0.0
        V[bad] = 0.0
    state = EKFState(torch.randn((B, nx), generator=gen, dtype=dtype), Sigma)
    return model, state, torch.randn((B, ny), generator=gen, dtype=dtype), V


def _cholesky_update(model, state, y, V):
    """ekf_correct's update with its gain solved through a Cholesky factor
    of the innovation covariance, written out."""
    C, Sig = model.C, state.Sigma
    S = C @ Sig @ C.T + V
    L = torch.linalg.cholesky(S.transpose(-1, -2))
    Kt = torch.linalg.solve_triangular(
        L.transpose(-1, -2),
        torch.linalg.solve_triangular(L, C @ Sig.transpose(-1, -2),
                                      upper=False), upper=True)
    K = Kt.transpose(-1, -2)
    x = state.x + (K @ (y - model.y_ref - state.x @ C.T)[..., None])[..., 0]
    I = torch.eye(state.x.shape[-1], dtype=state.x.dtype)
    return EKFState(x, (I - K @ C) @ Sig), S


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("what", ["kinv", "ekf"])
def test_an_info_flag_gives_the_same_bits(what, dtype):
    """make_kinv with a flag gives the bits it gives without one. Given a
    flag, ekf_correct solves for its gain with a Cholesky factor in place
    of the default's LU (a CUDA graph can hold the one and not the other
    on a card): the same bits as that update written out, and, the two
    being backward stable, within 8 n_y cond(S) eps of the LU's update in
    the largest entry's scale."""
    args = _kinv_args(dtype) if what == "kinv" else _ekf_args(dtype)
    fn = make_kinv if what == "kinv" else ekf_correct
    info = torch.zeros((), dtype=torch.bool)
    now, later = fn(*args), fn(*args, info=info)
    assert not bool(info)
    if what == "kinv":
        assert torch.equal(now, later)
        return
    want, S = _cholesky_update(*args)
    assert all(torch.equal(a, b) for a, b in zip(later, want))
    eps = torch.finfo(dtype).eps
    tol = 8 * S.shape[-1] * float(torch.linalg.cond(S).max()) * eps
    for a, b in zip(later, now):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("what", ["kinv", "ekf"])
def test_a_failed_factorization_sets_the_flag_and_the_default_raises(what):
    args = (_kinv_args(torch.float64, bad=3) if what == "kinv"
            else _ekf_args(torch.float64, bad=3))
    fn = make_kinv if what == "kinv" else ekf_correct
    info = torch.zeros((), dtype=torch.bool)
    fn(*args, info=info)
    assert bool(info)
    # a flag once set stays set: failures of a call are OR-ed together
    fn(*(_kinv_args(torch.float64) if what == "kinv"
         else _ekf_args(torch.float64)), info=info)
    assert bool(info)
    with pytest.raises(torch.linalg.LinAlgError):
        fn(*args)


def _fleet(model, fused):
    """The made-up dictionary's batched loop (condensed, 2 rho stages) and
    its inputs, loop BAD starting at the far point BAD."""
    mpc = BatchMPC(model, 10.0 * np.eye(3), 1e-2 * np.eye(CABLES), N=N,
                   dt=0.01, N_replan=N_REPLAN,
                   U=HyperRectangle(np.ones(CABLES), -np.ones(CABLES)),
                   qp_iters=4, x_step="kinv", formulation="condensed",
                   scaling_iters=2, rho_stages=2, dtype=torch.float64,
                   device="cpu")
    gen = torch.Generator().manual_seed(2)
    x0 = 0.1 * torch.randn((B, 2 * model.q.shape[1]), generator=gen,
                           dtype=torch.float64)
    zt = 0.1 * torch.randn((B, WINDOWS, N + 1, 3), generator=gen,
                           dtype=torch.float64)
    if fused:
        return mpc, mpc.build_fused(WINDOWS), x0, zt
    mpc.build(WINDOWS)
    return mpc, mpc.run_batch, x0, zt


def test_the_fused_call_raises_at_its_end_when_one_qp_fails():
    """One loop's dictionary point has a NaN B_d, so its QPs' K are not
    positive definite: the fused call runs to its end, then raises; the
    loop of `build` raises at the first K^-1."""
    checks = []
    for fused in (True, False):
        model = made_up_tpwl(8, 2, CABLES, 2, [0, 1], [1], far=[BAD])
        mpc, run, x0, zt = _fleet(model, fused)
        clean = run(x0, x0, zt) if fused else None
        mpc.model.B_d[BAD] = float("nan")
        x0[BAD] = torch.cat([model.v[BAD], model.q[BAD]])
        real = StageGraphs.check
        StageGraphs.check = lambda self: (checks.append(bool(self.info)),
                                          real(self))
        try:
            with pytest.raises(torch.linalg.LinAlgError) as err:
                run(x0, x0, zt)
        finally:
            StageGraphs.check = real
        assert ("batch-fused MPC" in str(err.value)) == fused
        if fused:
            assert bool(torch.isfinite(clean["z"]).all())
    assert checks == [True]


def test_on_the_cpu_the_stage_runner_runs_the_bodies_and_counts_nothing():
    model = made_up_tpwl(8, 2, CABLES, 2, [0, 1], [1])
    mpc, run, x0, zt = _fleet(model, True)
    counts = StageGraphs.replays, StageGraphs.eager
    outs = [run(x0, x0, zt) for _ in range(3)]
    assert (StageGraphs.replays, StageGraphs.eager) == counts
    assert all(torch.equal(o["z"], outs[0]["z"])
               and torch.equal(o["u"], outs[0]["u"]) for o in outs)
    (runner,) = mpc._stages.values()
    assert runner.calls == 3 and runner.graphs == {}


class _Replay:
    """An emulated CUDA graph: each replay runs the body again on the
    static inputs and writes the outputs in place."""

    def __init__(self, body, static, out):
        self.body, self.static, self.out = body, static, out

    def replay(self):
        new = self.body(*self.static)
        new = new if isinstance(new, tuple) else (new,)
        for o, n in zip(self.out, new):
            if o.data_ptr() != n.data_ptr():
                o.copy_(n)


class _Emulated(StageGraphs):
    """StageGraphs on the CPU with emulated graphs: a capture runs the body
    once and moves each output that is not a view of an input to memory of
    its own, as a graph's pool holds it."""

    def __init__(self, device):
        super().__init__(device)
        self.cuda = True

    def _graph(self, body, static):
        StageGraphs.eager += 1
        out = body(*static)
        flat = out if isinstance(out, tuple) else (out,)
        mine = {s.untyped_storage().data_ptr() for s in static
                if s is not None}
        flat = tuple(o if o.untyped_storage().data_ptr() in mine
                     else o.clone() for o in flat)
        return (_Replay(body, static, flat),
                flat if isinstance(out, tuple) else flat[0])

    def _replay(self, graph):
        graph.replay()


@pytest.mark.parametrize("formulation,trust_region", [
    ("condensed", False), ("sparse", False), ("sparse", True)])
def test_emulated_replays_give_the_bits_of_the_bodies_run_as_they_are(
        formulation, trust_region):
    model = made_up_tpwl(16, 3, CABLES, 4, [0, 1, 2], [1])

    def mpc():
        return BatchMPC(model, 100.0 * np.eye(3), 1e-3 * np.eye(CABLES), N=4,
                        dt=0.01, N_replan=N_REPLAN,
                        U=HyperRectangle(np.ones(CABLES), np.zeros(CABLES)),
                        qp_iters=8, rho_stages=4, x_step="kinv",
                        formulation=formulation, trust_region=trust_region,
                        scaling_iters=3, dtype=torch.float64, device="cpu")

    graphed, eager = mpc(), mpc()
    windows, Bsz = 3, 6
    runner = graphed._stages[torch.device("cpu"), Bsz] = _Emulated(
        torch.device("cpu"))
    run, ref = (m.build_fused(windows, noise_std=0.1)
                for m in (graphed, eager))
    counts = []
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        x0 = 0.05 * torch.randn((Bsz, 6), generator=gen, dtype=torch.float64)
        zt = model.z_ref + 0.05 * torch.randn((Bsz, windows, 5, 3),
                                              generator=gen,
                                              dtype=torch.float64)
        noise = torch.randn((windows, N_REPLAN, Bsz, 18), generator=gen,
                            dtype=torch.float64)
        before = StageGraphs.replays
        got = run(x0, x0.clone(), zt, noise)
        counts.append(StageGraphs.replays - before)
        eager._stages.clear()
        want = ref(x0, x0.clone(), zt, noise)
        for k in ("z", "u"):
            assert torch.equal(got[k], want[k]), (seed, k)
    # a window: assemble, Ruiz, 4 K^-1, 3 rebalances, recover, and two
    # ticks of a body and an EKF correction
    assert counts == [0] + [windows * 14] * 3
    # one graph a stage; the tick's body runs in its caller's span
    assert {k[0] for k in runner.graphs} == {
        "ekf.correct", None, "qp.assemble", "qp.kinv", "qp.recover",
        "qp.rho", "qp.ruiz"}
    assert len(runner.graphs) == 7
