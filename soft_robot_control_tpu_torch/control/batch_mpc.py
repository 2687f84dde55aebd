"""Batched closed-loop MPC + EKF on a TPWL model.

B independent closed loops (TPWL model as plant, EKF, one LOCP solve per
window) advance together along a leading batch axis. Each replanning window
does:

1. shift the last plan by N_replan steps;
2. fetch the nearest dictionary point's (A_d, B_d, d_d) for every plan
   state of every loop, in one launch of the TPWL select kernel;
3. assemble the QP, sparse (states kept as variables, scp/locp.py) or
   condensed (states eliminated, scp/locp_condensed.py), and
   Ruiz-equilibrate it;
4. solve it with fixed-iteration ADMM. The batch-fused loop
   (`build_fused`) runs `rho_stages` stages, each one launch of the batched
   ADMM kernel with a fresh K^-1 and the per-loop rho folded into the
   constraint rows. The loop of `build` and `run_batch` picks the sparse
   QP's solver from `use_pallas` (the single-QP M1 kernel, one launch per
   loop) and `x_step` ('kinv': the staged kernel path, 'chol': a Cholesky
   solve every iteration);
5. run N_replan ticks: DARE-gain feedback at the plan point, command
   clamp, plant step, EKF predict and correct. The three nearest-point
   lookups of a tick (plan point, plant state, estimate) go through one
   select launch, which copies dynamics rows for the plant state and the
   estimate only: at the plan point only the index (the DARE gain) is
   used.

On a card, `build_fused` replays the bodies of steps 3-5 (all but the
selects, the ADMM launches and the window's own operations) as CUDA
graphs from its second call at a batch size on (`StageGraphs`), and reads
the factorizations' error flag once a call, at its end.

The semantics are those of the JAX package's BatchMPC (real-time mode:
one LOCP per query, plan feedback with per-point DARE gains).

`BatchSSMMPC` runs the same kind of batch on an SSM model, the model also
the plant: each window relinearizes the polynomial dynamics and the
nonlinear output chart along the shifted plan, solves one LOCP a loop (one
launch of the batched ADMM kernel for the whole batch in `build_fused`)
and runs N_replan feedforward ticks behind the manifold observer.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.estimators.ekf import EKFState, ekf_correct
from soft_robot_control_tpu_torch.lqr.riccati import dare
from soft_robot_control_tpu_torch.ops.admm_batched import (admm_batched,
                                                           admm_batched_plain)
from soft_robot_control_tpu_torch.ops.admm_single import admm_fixed_single
from soft_robot_control_tpu_torch.qp.admm import (OSQP_RHO_EQ_SCALE, RHO_MAX,
                                                  RHO_MIN, _ruiz_equilibrate)
from soft_robot_control_tpu_torch.qp.blocked import (chol_blocked,  # noqa: F401
                                                     make_kinv,
                                                     tri_inv_blocked)
from soft_robot_control_tpu_torch.scp.locp import LOCPParams, LOCPSpec
from soft_robot_control_tpu_torch.scp.locp_condensed import (CondensedParams,
                                                             CondensedSpec)
from soft_robot_control_tpu_torch.utils.device import as_tensor, resolve_device
from soft_robot_control_tpu_torch.utils.timing import span, spans


def admm_fixed(P, q, A, l, u, w0, y0, rho_vec, iters: int, sigma=1e-6,
               alpha=1.6):
    """Warm-started fixed-iteration ADMM for a batch of QPs (OSQP update
    rule, no termination check): K is factored once and every iteration
    solves with the Cholesky factor. P (B,n,n), A (B,m,n), q, w0 (B,n),
    l, u, y0 (B,m), rho_vec (m,) or (B,m). Returns (w, y)."""
    n = P.shape[-1]
    At = A.transpose(-1, -2)
    K = (P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
         + (At * rho_vec[..., None, :]) @ A)
    chol = torch.linalg.cholesky(K)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    w, y = w0, y0
    z = torch.clamp(mv(A, w), l, u)
    for _ in range(int(iters)):
        rhs = sigma * w - q + mv(At, rho_vec * z - y)
        w_t = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        z_t = mv(A, w_t)
        w = alpha * w_t + (1 - alpha) * w
        z_rel = alpha * z_t + (1 - alpha) * z
        z_new = torch.clamp(z_rel + y / rho_vec, l, u)
        y = y + rho_vec * (z_rel - z_new)
        z = z_new
    return w, y


def admm_fixed_kinv(Kinv, q, A, l, u, w0, y0, rho_vec, iters: int,
                    sigma=1e-6, alpha=1.6):
    """Fixed-iteration ADMM with a precomputed K^-1 (B,n,n), in plain
    PyTorch: every iteration is mat-vecs and element-wise updates. rho_vec
    (m,) or (B,m)."""
    return admm_batched_plain(Kinv, A, q, l, u, rho_vec, w0, y0, iters,
                              sigma, alpha)


def admm_staged_kinv(P, q, A, l, u, w0, y0, rho0_vec, iters: int,
                     stages: int = 1, sigma=1e-6, alpha=1.6):
    """Fixed-total-iteration ADMM with `stages` rho re-balancing points, in
    plain PyTorch with the per-row rho kept explicit: run iters/stages
    iterations, re-balance each QP's rho from its scaled residual ratio,
    rebuild K^-1, repeat. `admm_staged_batched` computes the same through
    the kernel with the rho folded into the rows."""
    per = max(1, iters // stages)
    rho = rho0_vec.expand(l.shape)
    w, y = w0, y0
    for s in range(stages):
        Kinv = make_kinv(P, A, rho, sigma)
        w, y = admm_fixed_kinv(Kinv, q, A, l, u, w, y, rho, per, sigma,
                               alpha)
        if s < stages - 1:
            mult = _rho_multiplier(P, q, A, l, u, w, y)
            rho = torch.clamp(rho * mult[:, None], RHO_MIN, RHO_MAX)
    return w, y


def equilibrate_qp(P, q, A, l, u, w0, y0, iters: int = 6):
    """Ruiz-equilibrate a batch of QPs and carry bounds and warm start into
    the scaled space. Returns scaled (P, q, A, l, u, w0, y0) and the
    scalings (d, e, c) that map the solution back: w = d w_s,
    y = e y_s / c."""
    with span("qp.ruiz"):
        Ps, qs, As, d, e, c = _ruiz_equilibrate(P, q, A, iters)
        return (Ps, qs, As, e * l, e * u, w0 / d, c[:, None] * y0 / e,
                (d, e, c))


def _rho_multiplier(P, q, A, l, u, w, y):
    """OSQP residual-balance rho multiplier sqrt(pri_rel / dua_rel) of each
    QP of the batch at its iterate (w, y), with z = clip(Aw, l, u)."""
    amax = lambda t: t.abs().amax(dim=-1)
    Ax = torch.einsum("bmn,bn->bm", A, w)
    z = torch.clamp(Ax, l, u)
    pri = amax(Ax - z)
    pri_sc = torch.clamp(torch.maximum(amax(Ax), amax(z)), min=1e-12)
    Px = torch.einsum("bij,bj->bi", P, w)
    Aty = torch.einsum("bmn,bm->bn", A, y)
    dua = amax(Px + q + Aty)
    dua_sc = torch.maximum(torch.maximum(amax(Px), amax(Aty)),
                           torch.clamp(amax(q), min=1e-12))
    return torch.sqrt((pri / pri_sc) / torch.clamp(dua / dua_sc, min=1e-18))


def _rebalanced(P, q, A, l, u, w, y, rho):
    """Each QP's per-row rho after a rho stage, from its residual ratio."""
    with span("qp.rho"):
        mult = _rho_multiplier(P, q, A, l, u, w, y)
        return torch.clamp(rho * mult[:, None], RHO_MIN, RHO_MAX)


def _run(name, body, *inputs):
    """A stage body run as it is, in the span it opens itself: the stage
    runner of every loop but the batch-fused one (StageGraphs)."""
    return body(*inputs)


def admm_staged_batched(P, q, A, l, u, w0, y0, rho0_vec, iters: int,
                        stages: int, sigma=1e-6, alpha=1.6, info=None,
                        stage=_run):
    """Fixed-total-iteration ADMM in `stages` launches of the batched
    kernel, re-balancing each QP's rho between stages.

    The kernel takes one shared rho row, but after the first rebalance each
    QP wants its own. A per-row rho is equivalent to scaling row i of the
    constraints by sqrt(rho_i) at unit rho, so the rho is folded into
    A/l/u/y and the kernel always runs at rho = 1.

    info: as for make_kinv. stage(name, body, *tensors): the runner of the
    K^-1 builds and the rebalances (StageGraphs in the batch-fused loop)."""
    Bsz, m = l.shape
    per = max(1, iters // stages)
    rho = rho0_vec.expand(Bsz, m)
    ones = torch.ones(m, dtype=q.dtype, device=q.device)
    kinv = lambda P, As, ones, info: make_kinv(P, As, ones, sigma, info)
    w, y = w0, y0
    for s in range(stages):
        srt = torch.sqrt(rho)
        As = A * srt[:, :, None]
        Kinv = stage("qp.kinv", kinv, P, As, ones, info)
        w, ys = admm_batched(Kinv, As, q, srt * l, srt * u, ones, w, y / srt,
                             per, sigma, alpha)
        y = srt * ys
        if s < stages - 1:
            rho = stage("qp.rho", _rebalanced, P, q, A, l, u, w, y, rho)
    return w, y


def admm_staged_pallas(P, q, A, l, u, w0, y0, rho0_vec, iters: int,
                       stages: int, interpret: bool = False, sigma=1e-6,
                       alpha=1.6):
    """The JAX package's name and arguments for `admm_staged_batched`.
    `interpret` runs the Pallas kernel in interpret mode on a TPU; it has
    no meaning here and is ignored."""
    return admm_staged_batched(P, q, A, l, u, w0, y0, rho0_vec, iters,
                               stages, sigma, alpha)


def _same(a, b) -> bool:
    """Whether tensors a and b are one view of one memory."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class StageGraphs:
    """The stage runner of the batch-fused loop at one batch size on one
    device: the bodies of the QP build's and the ticks' spans (`qp.assemble`,
    `qp.ruiz`, `qp.kinv`, `qp.rho`, `qp.recover`, the part of `mpc.tick`
    after its select, `ekf.correct`), each a function of tensors (or None)
    that gives a tuple of tensors or a tensor. A stage's name is the span
    its body opens when it runs as it is, and the span a replay runs in;
    None for the tick's body, which runs in its caller's `mpc.tick`.

    On a card the loop's first call runs the bodies as they are, which
    warms the libraries; the second captures each body as a CUDA graph the
    first time it meets it (after one run on a side stream) and replays
    it; later calls replay. A replay first copies each input into the
    graph's own copy of it, unless the input is the output of a graph of
    this runner that the graph read when it was captured. It gives the
    graph's outputs, which its next replay overwrites: each is consumed, or
    cloned, before that. The select, the ADMM launches and the window's own
    operations run between the replays as they are. A stage's body is the
    same function of its inputs at every use of its name; a name with
    inputs of other shapes, or None where there was a tensor, is another
    graph. On the CPU the bodies run as they are, always.

    `info` is the loop's deferred error flag (make_kinv, ekf_correct),
    cleared by `begin` at the start of each call and read once, by
    `check`, at its end.

    `replays` and `eager` count the stage bodies that the process has run
    as a graph replay, and as they are on a card (the warm-up calls and
    the side-stream runs before a capture)."""

    replays = 0
    eager = 0

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.calls = 0
        self.graphs = {}     # key -> (graph, static inputs, outputs)
        self.outputs = []    # every captured graph's outputs
        self.info = torch.zeros((), dtype=torch.bool, device=device)
        self.outputs.append(self.info)
        self.side = None

    def begin(self):
        self.info.zero_()
        self.calls += 1

    def check(self):
        """Raises torch.linalg.LinAlgError if a factorization of the call
        failed: the call's one host read."""
        if bool(self.info):
            raise torch.linalg.LinAlgError(
                "batch-fused MPC: a QP's K (qp.kinv) or an EKF innovation "
                "covariance (ekf.correct) was not positive definite in "
                "this call")

    def __call__(self, name, body, *inputs):
        if not self.cuda:
            return body(*inputs)
        if self.calls < 2:
            StageGraphs.eager += 1
            return body(*inputs)
        key = (name,) + tuple(None if t is None else (tuple(t.shape), t.dtype)
                              for t in inputs)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(body, inputs)
        graph, static, shared, out = entry
        with span(name) if name else contextlib.nullcontext():
            for s, t, sh in zip(static, inputs, shared):
                if t is s or t is None:
                    continue
                if not sh:
                    s.copy_(t)
                elif not _same(s, t):
                    raise RuntimeError(
                        f"stage {name}: its graph reads another graph's "
                        "output, and was given another tensor")
            self._replay(graph)
        StageGraphs.replays += 1
        return out

    def _capture(self, body, inputs):
        """(graph, static inputs, which of them are other graphs' outputs,
        outputs) of `body` on copies of `inputs`."""
        static, shared = [], []
        for t in inputs:
            o = None if t is None else next(
                (o for o in self.outputs if _same(o, t)), None)
            shared.append(o is not None)
            static.append(o if t is None or o is not None
                          else torch.empty_like(t).copy_(t))
        graph, out = self._graph(body, static)
        flat = out if isinstance(out, tuple) else (out,)
        self.outputs += [o for o in flat if torch.is_tensor(o)]
        return graph, static, shared, out

    def _graph(self, body, static):
        """body(*static) captured as a CUDA graph after one run on a side
        stream: (graph, its outputs)."""
        with torch.cuda.device(self.device):
            if self.side is None:
                self.side = torch.cuda.Stream()
            self.side.wait_stream(torch.cuda.current_stream())
            with spans(False), torch.cuda.stream(self.side):
                body(*static)
            StageGraphs.eager += 1
            torch.cuda.current_stream().wait_stream(self.side)
            graph = torch.cuda.CUDAGraph()
            with spans(False), torch.cuda.graph(graph):
                out = body(*static)
        return graph, out

    def _replay(self, graph):
        with torch.cuda.device(self.device):
            graph.replay()


class BatchMPC:
    """Batched closed-loop MPC + EKF on a TPWL model."""

    def __init__(self, model, Qz, R, N: int, dt: float, N_replan: int = 1,
                 U=None, dU=None, x_char=None, rho: float = 0.1,
                 qp_iters: int = 100, scp_iters: int = 1,
                 W=None, V=None, Qk=None, Rk=None,
                 delta0: float = 1e4, omega0: float = 1.0,
                 trust_region: bool = False, use_pallas: bool = False,
                 x_step: str = "chol", formulation: str = "sparse",
                 scaling_iters: int = 6, rho_stages: int = 1,
                 dtype=torch.float32, device="cuda"):
        """
        model: TPWLModel with output and measurement models set; it is
               pre-discretized at dt, cast to dtype and moved to device.
        Qz, R: MPC cost. Qk, Rk: feedback-gain cost (default H'QzH, R).
        W, V: EKF covariances.
        formulation: 'sparse' keeps x as QP variables; 'condensed'
            eliminates them by forward substitution, with the same optimum
            when there is no trust region.
        use_pallas: `build`/`run_batch` solve the sparse QP with the
            single-QP M1 kernel (the name is the JAX package's).
        x_step: otherwise, the sparse QP's x-step in `build`/`run_batch`:
            'chol' (a Cholesky solve per iteration) or 'kinv' (K^-1
            precomputed per rho stage; the batched kernel on a card).
        delta0, omega0, x_char: trust-region radius, slack weight and state
            scale of the sparse QP with trust_region=True.
        """
        if formulation not in ("sparse", "condensed"):
            raise ValueError(f"unknown formulation {formulation!r}")
        if formulation == "condensed" and trust_region:
            raise NotImplementedError(
                "the condensed formulation eliminates x, so the trust "
                "region (a constraint on x) needs the sparse spec")
        if x_step not in ("chol", "kinv"):
            raise ValueError(f"unknown x_step {x_step!r}")
        dev = resolve_device(device)
        self.device, self.dtype = dev, dtype
        self.dt = float(dt)
        self.N = int(N)
        self.N_replan = int(N_replan)
        m = model.to(device=dev).pre_discretize(self.dt).to(dtype=dtype)
        self.model = m
        self.n_x, self.n_u, self.n_z = m.state_dim, m.input_dim, m.H.shape[0]
        self.n_y = m.C.shape[0]
        t = lambda a: as_tensor(a, dtype, dev)

        Qz, R = t(Qz), t(R)
        self.qp_iters = int(qp_iters)
        self.scp_iters = int(scp_iters)
        self.scaling_iters = int(scaling_iters)
        self.rho_stages = int(rho_stages)
        self.formulation = formulation
        self.use_pallas = bool(use_pallas)
        self.x_step = x_step
        self.delta0, self.omega0 = float(delta0), float(omega0)
        # executed-command clamp: actuation limits on the final command
        # (the DARE feedback term lies outside the QP's constraint set)
        self.u_clamp = None
        if isinstance(U, HyperRectangle):
            self.u_clamp = (t(-U.b[1::2]), t(U.b[0::2]))
        if formulation == "condensed":
            self.cspec = CondensedSpec(self.N, m.H, Qz, R, U=U, dU=dU,
                                       dtype=dtype, device=dev)
            # all rows are inequalities: no equality-rho boost
            self.rho_vec_c = torch.full((self.cspec.n_con,), rho,
                                        dtype=dtype, device=dev)
        else:
            # the trust region is inert in the real-time single-LOCP mode
            # (delta0=1e4 never binds); without it the QP has a third of
            # the rows
            spec = LOCPSpec(self.N, m.H, Qz, R, U=U, dU=dU, x_char=x_char,
                            is_tr_active=trust_region, dtype=dtype,
                            device=dev)
            self.spec = spec
            # per-row rho: the equalities get the OSQP 1e3 boost
            rho_vec = np.full(spec.n_con, rho)
            nx = self.n_x
            rho_vec[spec.r_init:spec.r_init + nx] *= OSQP_RHO_EQ_SCALE
            rho_vec[spec.r_dyn:spec.r_dyn + self.N * nx] *= OSQP_RHO_EQ_SCALE
            self.rho_vec = t(rho_vec)
        self.W = t(W) if W is not None else 100.0 * torch.eye(
            self.n_x, dtype=dtype, device=dev)
        self.V = t(V) if V is not None else torch.eye(
            self.n_y, dtype=dtype, device=dev)
        # per-TPWL-point DARE feedback gains (tpwl/controllers.py:239-246)
        Qk = t(Qk) if Qk is not None else m.H.T @ Qz @ m.H
        Rk = t(Rk) if Rk is not None else R
        self.K_pts, _ = dare(m.A_d, m.B_d, Qk, Rk)
        # the dictionary split over a mesh's mp axis (parallel/mesh.py:
        # sharded_batch_mpc_fused_mp): (PointShards, the mesh row's
        # devices), and every nearest-point fetch goes through it
        self._mp = None
        self._run = None
        # the batch-fused loop's stage runners by (device, B), and the
        # running call's runner and deferred error flag for `_tick`
        self._stages = {}
        self._tick_stage = (_run, None)
        # GuSTO's trust-region radius and slack weight as tensors: a graph
        # captures no host-to-device copy of a number
        self._tr = (t(self.delta0), t(self.omega0))

    # ------------------------------------------------------------------
    def _shift_plan(self, x_plan, u_plan):
        """Advance the previous plans (B, N+1, n_x), (B, N, n_u) by N_replan
        steps so the linearization trajectory is time-aligned with the new
        window; entries past the old horizon repeat the last plan point."""
        k = self.N_replan

        def sh(a):
            return torch.cat([a[:, k:], a[:, -1:].expand(-1, k, -1)], dim=1)

        return sh(x_plan), sh(u_plan)

    def _select(self, x, index_only: int = 0, gains: bool = False):
        """Nearest-point index of each state of x (B, n_x), the (A_d, B_d,
        d_d) rows of states index_only.., and with `gains` the DARE gains of
        states ..index_only (else None): one launch of the select kernel,
        or in mp mode the sharded select over the mesh row's parts."""
        if self._mp is not None:
            shards, devices = self._mp
            return shards.select(x, devices, index_only, gains)
        idx, A, Bm, d = self.model.select(x, index_only)
        return (idx, A, Bm, d,
                self.K_pts[idx[:index_only]] if gains else None)

    def _gather_traj(self, x_k):
        """(A_d, B_d, d_d) at the first N states of each plan, (B, N, ...)."""
        Bsz, n = x_k.shape[0], self.n_x
        _, A, Bm, d, _ = self._select(x_k[:, :-1].reshape(-1, n))
        return (A.reshape(Bsz, self.N, n, n),
                Bm.reshape(Bsz, self.N, n, self.n_u),
                d.reshape(Bsz, self.N, n))

    def _qp_dims(self):
        spec = self.cspec if self.formulation == "condensed" else self.spec
        return spec.n_var, spec.n_con

    def _solve_qp(self, P, q, A, l, u, w0, y0, fused: bool, stage=_run,
                  info=None):
        """The window's (already equilibrated) QPs through the solver that
        the formulation, the loop and the options select."""
        if self.formulation == "condensed":
            return admm_staged_batched(P, q, A, l, u, w0, y0, self.rho_vec_c,
                                       self.qp_iters, self.rho_stages,
                                       info=info, stage=stage)
        if fused or (not self.use_pallas and self.x_step == "kinv"):
            return admm_staged_batched(P, q, A, l, u, w0, y0, self.rho_vec,
                                       self.qp_iters, self.rho_stages,
                                       info=info, stage=stage)
        if self.use_pallas:
            sols = [admm_fixed_single(P[b], q[b], A[b], l[b], u[b], w0[b],
                                      y0[b], self.rho_vec, self.qp_iters)
                    for b in range(q.shape[0])]
            return (torch.stack([w for w, _ in sols]),
                    torch.stack([y for _, y in sols]))
        return admm_fixed(P, q, A, l, u, w0, y0, self.rho_vec, self.qp_iters)

    def _assemble(self, Ad, Bd, dd, x0, z_win, x_plan=None):
        """The window's QPs: (P, q, A, l, u), and the condensed
        formulation's forward-substitution maps (xfree, G)."""
        with span("qp.assemble"):
            Bsz = x0.shape[0]
            zeros = lambda *shape: torch.zeros(
                (Bsz,) + shape, dtype=self.dtype, device=self.device)
            if self.formulation == "condensed":
                P, q, A, l, u, _, xfree, G = self.cspec.assemble(
                    CondensedParams(Ad=Ad, Bd=Bd, dd=dd, x0=x0, z=z_win,
                                    u_des=zeros(self.N, self.n_u)))
                return P, q, A, l, u, xfree, G
            return self.spec.assemble(LOCPParams(
                Ad=Ad, Bd=Bd, dd=dd, x0=x0, xk=x_plan, delta=self._tr[0],
                omega=self._tr[1], z=z_win, zf=zeros(self.n_z),
                u_des=zeros(self.N, self.n_u)))[:5]

    def _equilibrate(self, P, q, A, l, u, w0, y0):
        """equilibrate_qp with the scalings (d, e, c) flat at the end."""
        *qp, scalings = equilibrate_qp(P, q, A, l, u, w0, y0,
                                       self.scaling_iters)
        return (*qp, *scalings)

    def _recover(self, w, y, d_s, e_s, c_s, xfree=None, G=None):
        """The solution unscaled (scalings None: none) and the plans it
        gives: (x_plan, u_plan, w, y)."""
        with span("qp.recover"):
            if d_s is not None:
                w = d_s * w
                y = e_s * y / c_s[:, None]
            if self.formulation == "condensed":
                u_plan = w.reshape(w.shape[0], self.N, self.n_u)
                x_plan = self.cspec.recover_x(xfree, G, w)
            else:
                x_plan, u_plan, _ = self.spec.split(w)
            return x_plan, u_plan, w, y

    def _mpc_query_batched(self, x0, x_plan, u_plan, z_win, warm,
                           fused: bool, stage=_run, info=None):
        """One LOCP solve per loop, linearized along its shifted plan.
        z_win holds absolute targets (B, N+1, n_z). `stage` runs the bodies
        of the QP build's spans; `info`: as for make_kinv."""
        with span("mpc.window"):
            x_plan, u_plan = self._shift_plan(x_plan, u_plan)
            z_win = z_win - self.model.z_ref
            condensed = self.formulation == "condensed"
            for _ in range(self.scp_iters):
                w0, y0 = warm
                Ad, Bd, dd = self._gather_traj(x_plan)
                qp = stage("qp.assemble", self._assemble, Ad, Bd, dd, x0,
                           z_win, *(() if condensed else (x_plan,)))
                P, q, A, l, u = qp[:5]
                scalings = (None, None, None)
                if self.scaling_iters > 0:
                    P, q, A, l, u, w0, y0, *scalings = stage(
                        "qp.ruiz", self._equilibrate, P, q, A, l, u, w0, y0)
                w, y = self._solve_qp(P, q, A, l, u, w0, y0, fused, stage,
                                      info)
                x_plan, u_plan, w, y = stage("qp.recover", self._recover,
                                             w, y, *scalings, *qp[5:])
                warm = (w, y)
            return x_plan, u_plan, warm

    def _tick(self, x_p, ekf, x_plan, u_plan, k, noise):
        """One controller tick for every loop; `noise` (B, n_y) or None.
        The call's runner (`_tick_stage`) runs the tick's body after its
        select and the EKF correction, with its deferred error flag (as
        for ekf_correct). The tick keeps its six arguments: the
        benchmark's fault tests wrap it."""
        stage, info = self._tick_stage
        with span("mpc.tick"):
            Bsz = x_p.shape[0]
            x_bar, u_bar = x_plan[:, k], u_plan[:, k]
            # one select: the plan point's DARE gain, rows at the plant
            # state and the estimate only
            _, A, Bm, d, K = self._select(
                torch.cat([x_bar, x_p, ekf.x], dim=0), index_only=Bsz,
                gains=True)
            x_next, z, u, y, x_pred, S_pred = stage(
                None, self._tick_body, A, Bm, d, K, x_p, ekf.x, ekf.Sigma,
                x_bar, u_bar, noise)
            ekf = EKFState(*stage("ekf.correct", self._correct, x_pred,
                                  S_pred, y, info))
            return x_next, ekf, z, u

    def _tick_body(self, A, Bm, d, K, x_p, x_e, Sigma, x_bar, u_bar, noise):
        """A tick after its select: the command, the plant step, the
        measurement, the EKF prediction and the output,
        (x_next, z, u, y, x_pred, Sigma_pred)."""
        m = self.model
        Bsz = x_p.shape[0]
        mv = lambda M, v: (M @ v[..., None])[..., 0]
        u = u_bar + mv(K, x_e - x_bar)
        if self.u_clamp is not None:
            u = torch.clamp(u, self.u_clamp[0], self.u_clamp[1])
        p, e = slice(0, Bsz), slice(Bsz, 2 * Bsz)
        x_next = mv(A[p], x_p) + mv(Bm[p], u) + d[p]
        y = x_next @ m.C.T + m.y_ref
        if noise is not None:
            y = y + noise
        A_e = A[e]
        x_pred = mv(A_e, x_e) + mv(Bm[e], u) + d[e]
        S_pred = A_e @ Sigma @ A_e.transpose(-1, -2) + self.W
        z = x_next @ m.H.T + m.z_ref
        return x_next, z, u, y, x_pred, S_pred

    def _correct(self, x, Sigma, y, info):
        return tuple(ekf_correct(self.model, EKFState(x, Sigma), y, self.V,
                                 info))

    def _draw_noise(self, n_windows: int, Bsz: int, generator=None):
        """Standard normal measurement noise (n_windows, N_replan, B, n_y)
        from `generator`, on its device (else the loop's)."""
        gdev = generator.device if generator is not None else self.device
        return torch.randn((int(n_windows), self.N_replan, Bsz, self.n_y),
                           generator=generator, dtype=self.dtype, device=gdev)

    # ------------------------------------------------------------------
    def _build_loop(self, n_windows: int, noise_std: float, fused: bool):
        """The batched closed loop over n_windows replanning windows (see
        build_fused for its signature)."""
        N, N_rep, n_win = self.N, self.N_replan, int(n_windows)
        dev, dt = self.device, self.dtype
        n_var, n_con = self._qp_dims()

        def run(x_plant0, ekf_x0, z_target, noise=None, generator=None):
            with span("mpc.call"):
                t = lambda a: as_tensor(a, dt, dev)
                x_p, x_e, z_target = t(x_plant0), t(ekf_x0), t(z_target)
                Bsz = x_p.shape[0]
                # the call's stage runner and deferred error flag
                stage, info = _run, None
                if fused:
                    stage = self._stages.get((dev, Bsz))
                    if stage is None:
                        stage = self._stages[dev, Bsz] = StageGraphs(dev)
                    stage.begin()
                    info = stage.info
                self._tick_stage = (stage, info)
                if noise_std > 0:
                    if noise is None:
                        noise = self._draw_noise(n_win, Bsz, generator)
                    noise = noise_std * t(noise)
                eye = torch.eye(self.n_x, dtype=dt, device=dev)
                ekf = EKFState(x_e, eye.expand(Bsz, -1, -1))
                x_plan = x_e[:, None].expand(-1, N + 1, -1)
                u_plan = torch.zeros((Bsz, N, self.n_u), dtype=dt,
                                     device=dev)
                warm = (torch.zeros((Bsz, n_var), dtype=dt, device=dev),
                        torch.zeros((Bsz, n_con), dtype=dt, device=dev))
                zs, us = [], []
                for w in range(n_win):
                    # replan from the current belief
                    x_plan, u_plan, warm = self._mpc_query_batched(
                        ekf.x, x_plan, u_plan, z_target[:, w], warm, fused,
                        stage, info)
                    for k in range(N_rep):
                        x_p, ekf, z, u = self._tick(
                            x_p, ekf, x_plan, u_plan, k,
                            None if noise_std <= 0 else noise[w, k])
                        # a graph's outputs: its next replay overwrites them
                        zs.append(z.clone())
                        us.append(u.clone())
                if fused:
                    stage.check()
                return {"z": torch.stack(zs, dim=1),
                        "u": torch.stack(us, dim=1)}

        return run

    def build_fused(self, n_windows: int, noise_std: float = 0.0):
        """The batch-fused closed loop over n_windows replanning windows;
        every window's QPs go through the staged batched ADMM kernel:

            run(x_plant0 (B,n_x), ekf_x0 (B,n_x),
                z_target (B,n_windows,N+1,n_z), noise=None, generator=None)
              -> {"z": (B, n_windows*N_replan, n_z),
                  "u": (B, n_windows*N_replan, n_u)}

        With noise_std > 0 the measurement noise is `noise_std` times
        `noise` (n_windows, N_replan, B, n_y) when given, else standard
        normal draws from `generator`.
        """
        return self._build_loop(n_windows, noise_std, fused=True)

    def build(self, n_windows: int, noise_std: float = 0.0):
        """The single-trajectory closed loop, with the QP solver that
        `use_pallas` and `x_step` select:

            run(x_plant0 (n_x,), ekf_x0 (n_x,), z_target (n_windows,N+1,n_z),
                noise=None, generator=None) -> {"z": (T, n_z), "u": (T, n_u)}

        with T = n_windows*N_replan and `noise` (n_windows, N_replan, n_y).
        It runs as the batched loop at B = 1; `run_batch` runs the same
        loop on a batch.
        """
        batched = self._build_loop(n_windows, noise_std, fused=False)
        self._run = batched

        def run(x_plant0, ekf_x0, z_target, noise=None, generator=None):
            t = lambda a: as_tensor(a, self.dtype, self.device)[None]
            if noise is not None:
                noise = as_tensor(noise)[:, :, None]
            logs = batched(t(x_plant0), t(ekf_x0), t(z_target), noise,
                           generator)
            return {k: v[0] for k, v in logs.items()}

        return run

    def run_batch(self, x_plant0, ekf_x0, z_target, noise=None,
                  generator=None):
        """The loop of the last `build` on a batch: x_plant0, ekf_x0
        (B, n_x), z_target (B, n_windows, N+1, n_z), noise as for
        build_fused. Each element's logs are those of `build`'s run."""
        if self._run is None:
            raise RuntimeError("call build() first")
        return self._run(x_plant0, ekf_x0, z_target, noise, generator)


class BatchSSMMPC:
    """Batched closed-loop MPC on an SSM model, the model also the plant.

    The SSM real-time configuration: each window relinearizes the
    polynomial dynamics and the nonlinear chart along the shifted previous
    plan (time-varying H_d, c_d in the QP objective), solves one LOCP a
    loop with fixed-iteration ADMM through an explicit K^-1, and runs
    N_replan feedforward ticks, with the algebraic manifold observer
    x = W_map(z - z_ref) of the plant's output. There is no Ruiz
    equilibration and no rho staging on this path. `build_fused` solves a
    window's B LOCPs in one launch of the batched ADMM kernel; `build` and
    `run_batch` solve them in plain PyTorch (the JAX package's XLA path).
    """

    def __init__(self, model, Qz, R, N: int, dt: float, N_replan: int = 1,
                 U=None, dU=None, qp_iters: int = 100, rho: float = 0.1,
                 x_step: str = "kinv", formulation: str = "condensed",
                 dtype=torch.float64, device="cuda"):
        """
        model: SSMModel; it is cast to dtype and moved to device.
        formulation: 'condensed' (states eliminated, N*n_u variables) or
            'sparse' (states kept, the init and dynamics rows with the
            OSQP 1e3 rho boost).
        x_step: the sparse QP's x-step in `build`/`run_batch`: 'kinv'
            (K^-1 built once a window) or any other value for a Cholesky
            solve every iteration; `build_fused` always takes K^-1.
        """
        if formulation not in ("sparse", "condensed"):
            raise ValueError(f"unknown formulation {formulation!r}")
        dev = resolve_device(device)
        self.device, self.dtype = dev, dtype
        self.dt = float(dt)
        self.N = int(N)
        self.N_replan = int(N_replan)
        m = model.to(dtype=dtype, device=dev)
        self.model = m
        self.n_x, self.n_u, self.n_z = m.state_dim, m.input_dim, m.output_dim
        self.x_step = x_step
        self.qp_iters = int(qp_iters)
        self.formulation = formulation
        t = lambda a: as_tensor(a, dtype, dev)
        Qz, R = t(Qz), t(R)
        self.spec = LOCPSpec(self.N, m.H, Qz, R, U=U, dU=dU,
                             nonlinear_observer=True, is_tr_active=False,
                             dtype=dtype, device=dev)
        spec = self.spec
        rho_vec = np.full(spec.n_con, rho)
        nx = self.n_x
        rho_vec[spec.r_init:spec.r_init + nx] *= OSQP_RHO_EQ_SCALE
        rho_vec[spec.r_dyn:spec.r_dyn + self.N * nx] *= OSQP_RHO_EQ_SCALE
        self.rho_vec = t(rho_vec)
        if formulation == "condensed":
            self.cspec = CondensedSpec(self.N, m.H, Qz, R, U=U, dU=dU,
                                       nonlinear_observer=True, dtype=dtype,
                                       device=dev)
            self.rho_vec_c = torch.full((self.cspec.n_con,), rho,
                                        dtype=dtype, device=dev)
        self._run = None

    def _qp_dims(self):
        spec = self.cspec if self.formulation == "condensed" else self.spec
        return spec.n_var, spec.n_con

    def _lin_traj(self, x_plan, u_plan):
        """Dynamics Jacobians at the first N plan points and the chart's at
        all N+1, for a batch of plans (B, N+1, n_x), (B, N, n_u)."""
        m = self.model
        Ad, Bd, dd = m.get_jacobians(x_plan[:, :-1], u_plan, self.dt)
        Hd, cd = m.get_observer_jacobians(x_plan)
        return Ad, Bd, dd, Hd, cd

    _shift_plan = BatchMPC._shift_plan

    def _mpc_query(self, x0, x_plan, u_plan, z_win, warm, fused: bool):
        """One LOCP a loop, linearized along its shifted plan. z_win holds
        shifted targets (B, N+1, n_z)."""
        x_plan, u_plan = self._shift_plan(x_plan, u_plan)
        Ad, Bd, dd, Hd, cd = self._lin_traj(x_plan, u_plan)
        Bsz = x0.shape[0]
        w0, y0 = warm
        zeros = lambda *shape: torch.zeros((Bsz,) + shape, dtype=self.dtype,
                                           device=self.device)
        if self.formulation == "condensed":
            P, q, A, l, u, _, xfree, G = self.cspec.assemble(CondensedParams(
                Ad=Ad, Bd=Bd, dd=dd, x0=x0, z=z_win,
                u_des=zeros(self.N, self.n_u), Hd=Hd, cd=cd))
            rho = self.rho_vec_c
        else:
            P, q, A, l, u, _ = self.spec.assemble(LOCPParams(
                Ad=Ad, Bd=Bd, dd=dd, x0=x0, xk=x_plan, delta=1e4, omega=1.0,
                z=z_win, zf=zeros(self.n_z), u_des=zeros(self.N, self.n_u),
                Hd=Hd, cd=cd))
            rho = self.rho_vec
        if fused:
            w, y = admm_batched(make_kinv(P, A, rho), A, q, l, u, rho, w0, y0,
                                self.qp_iters)
        elif self.formulation == "condensed" or self.x_step == "kinv":
            w, y = admm_fixed_kinv(make_kinv(P, A, rho), q, A, l, u, w0, y0,
                                   rho, self.qp_iters)
        else:
            w, y = admm_fixed(P, q, A, l, u, w0, y0, rho, self.qp_iters)
        if self.formulation == "condensed":
            u_plan = w.reshape(Bsz, self.N, self.n_u)
            x_plan = self.cspec.recover_x(xfree, G, w)
        else:
            x_plan, u_plan, _ = self.spec.split(w)
        return x_plan, u_plan, (w, y)

    def _build_loop(self, n_windows: int, fused: bool):
        """The batched closed loop over n_windows windows (see build_fused
        for its signature)."""
        m = self.model
        N, N_rep, n_win = self.N, self.N_replan, int(n_windows)
        dev, dt = self.device, self.dtype
        n_var, n_con = self._qp_dims()

        def run(x_plant0, z_target):
            x_p = as_tensor(x_plant0, dt, dev)
            z_target = as_tensor(z_target, dt, dev)
            Bsz = x_p.shape[0]
            x_plan = x_p[:, None].expand(-1, N + 1, -1)
            u_plan = torch.zeros((Bsz, N, self.n_u), dtype=dt, device=dev)
            warm = (torch.zeros((Bsz, n_var), dtype=dt, device=dev),
                    torch.zeros((Bsz, n_con), dtype=dt, device=dev))
            zs, us = [], []
            for w in range(n_win):
                # the manifold observer on the plant's measured output
                x_hat = m.compute_RO_state(m.x_to_zfyf(x_p))
                x_plan, u_plan, warm = self._mpc_query(
                    x_hat, x_plan, u_plan, z_target[:, w], warm, fused)
                for k in range(N_rep):
                    u = u_plan[:, k]  # feedforward only
                    x_p = m.update_state(x_p, u, self.dt)
                    zs.append(m.x_to_zfyf(x_p))
                    us.append(u)
            return {"z": torch.stack(zs, dim=1), "u": torch.stack(us, dim=1)}

        return run

    def build(self, n_windows: int):
        """The single-trajectory closed loop, its QPs solved in plain
        PyTorch:

            run(x_plant0 (n_x,), z_target (n_windows, N+1, n_z))
              -> {"z": (T, n_z), "u": (T, n_u)}

        with T = n_windows*N_replan, z_target the shifted targets and z the
        unshifted outputs. `run_batch` runs the same loop on a batch."""
        batched = self._build_loop(n_windows, fused=False)
        self._run = batched

        def run(x_plant0, z_target):
            t = lambda a: as_tensor(a, self.dtype, self.device)[None]
            return {k: v[0] for k, v in batched(t(x_plant0),
                                                t(z_target)).items()}

        return run

    def build_fused(self, n_windows: int):
        """The batch-fused closed loop; each window's B LOCPs go through one
        launch of the batched ADMM kernel:

            run(x_plant0 (B, n_x), z_target (B, n_windows, N+1, n_z))
              -> {"z": (B, n_windows*N_replan, n_z),
                  "u": (B, n_windows*N_replan, n_u)}
        """
        return self._build_loop(n_windows, fused=True)

    def run_batch(self, x_plant0, z_target):
        """The loop of the last `build` on a batch: x_plant0 (B, n_x),
        z_target (B, n_windows, N+1, n_z)."""
        if self._run is None:
            raise RuntimeError("call build() first")
        return self._run(x_plant0, z_target)


def window_targets(z_traj, n_windows: int, N_replan: int, N: int):
    """Slice a long target trajectory (T, n_z) into per-window solver targets
    (n_windows, N+1, n_z): window w starts at w*N_replan."""
    z_traj = np.asarray(z_traj)
    out = np.zeros((n_windows, N + 1, z_traj.shape[1]), dtype=z_traj.dtype)
    T = z_traj.shape[0]
    for w in range(n_windows):
        idx = np.clip(np.arange(w * N_replan, w * N_replan + N + 1), 0, T - 1)
        out[w] = z_traj[idx]
    return out
