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

The semantics are those of the JAX package's BatchMPC (real-time mode:
one LOCP per query, plan feedback with per-point DARE gains).
"""

from __future__ import annotations

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
from soft_robot_control_tpu_torch.qp.blocked import make_kinv
from soft_robot_control_tpu_torch.scp.locp import LOCPParams, LOCPSpec
from soft_robot_control_tpu_torch.scp.locp_condensed import (CondensedParams,
                                                             CondensedSpec)
from soft_robot_control_tpu_torch.utils.device import as_tensor, resolve_device


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
    Ps, qs, As, d, e, c = _ruiz_equilibrate(P, q, A, iters)
    return Ps, qs, As, e * l, e * u, w0 / d, c[:, None] * y0 / e, (d, e, c)


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


def admm_staged_batched(P, q, A, l, u, w0, y0, rho0_vec, iters: int,
                        stages: int, sigma=1e-6, alpha=1.6):
    """Fixed-total-iteration ADMM in `stages` launches of the batched
    kernel, re-balancing each QP's rho between stages.

    The kernel takes one shared rho row, but after the first rebalance each
    QP wants its own. A per-row rho is equivalent to scaling row i of the
    constraints by sqrt(rho_i) at unit rho, so the rho is folded into
    A/l/u/y and the kernel always runs at rho = 1."""
    Bsz, m = l.shape
    per = max(1, iters // stages)
    rho = rho0_vec.expand(Bsz, m)
    ones = torch.ones(m, dtype=q.dtype, device=q.device)
    w, y = w0, y0
    for s in range(stages):
        srt = torch.sqrt(rho)
        As = A * srt[:, :, None]
        Kinv = make_kinv(P, As, ones, sigma)
        w, ys = admm_batched(Kinv, As, q, srt * l, srt * u, ones, w, y / srt,
                             per, sigma, alpha)
        y = srt * ys
        if s < stages - 1:
            mult = _rho_multiplier(P, q, A, l, u, w, y)
            rho = torch.clamp(rho * mult[:, None], RHO_MIN, RHO_MAX)
    return w, y


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
        self._run = None

    # ------------------------------------------------------------------
    def _shift_plan(self, x_plan, u_plan):
        """Advance the previous plans (B, N+1, n_x), (B, N, n_u) by N_replan
        steps so the linearization trajectory is time-aligned with the new
        window; entries past the old horizon repeat the last plan point."""
        k = self.N_replan

        def sh(a):
            return torch.cat([a[:, k:], a[:, -1:].expand(-1, k, -1)], dim=1)

        return sh(x_plan), sh(u_plan)

    def _gather_traj(self, x_k):
        """(A_d, B_d, d_d) at the first N states of each plan, (B, N, ...)."""
        Bsz, n = x_k.shape[0], self.n_x
        _, A, Bm, d = self.model.select(x_k[:, :-1].reshape(-1, n))
        return (A.reshape(Bsz, self.N, n, n),
                Bm.reshape(Bsz, self.N, n, self.n_u),
                d.reshape(Bsz, self.N, n))

    def _qp_dims(self):
        spec = self.cspec if self.formulation == "condensed" else self.spec
        return spec.n_var, spec.n_con

    def _solve_qp(self, P, q, A, l, u, w0, y0, fused: bool):
        """The window's (already equilibrated) QPs through the solver that
        the formulation, the loop and the options select."""
        if self.formulation == "condensed":
            return admm_staged_batched(P, q, A, l, u, w0, y0, self.rho_vec_c,
                                       self.qp_iters, self.rho_stages)
        if fused or (not self.use_pallas and self.x_step == "kinv"):
            return admm_staged_batched(P, q, A, l, u, w0, y0, self.rho_vec,
                                       self.qp_iters, self.rho_stages)
        if self.use_pallas:
            sols = [admm_fixed_single(P[b], q[b], A[b], l[b], u[b], w0[b],
                                      y0[b], self.rho_vec, self.qp_iters)
                    for b in range(q.shape[0])]
            return (torch.stack([w for w, _ in sols]),
                    torch.stack([y for _, y in sols]))
        return admm_fixed(P, q, A, l, u, w0, y0, self.rho_vec, self.qp_iters)

    def _mpc_query_batched(self, x0, x_plan, u_plan, z_win, warm,
                           fused: bool):
        """One LOCP solve per loop, linearized along its shifted plan.
        z_win holds absolute targets (B, N+1, n_z)."""
        x_plan, u_plan = self._shift_plan(x_plan, u_plan)
        z_win = z_win - self.model.z_ref
        Bsz = x0.shape[0]
        condensed = self.formulation == "condensed"
        zeros = lambda *shape: torch.zeros((Bsz,) + shape, dtype=self.dtype,
                                           device=self.device)
        for _ in range(self.scp_iters):
            w0, y0 = warm
            Ad, Bd, dd = self._gather_traj(x_plan)
            if condensed:
                P, q, A, l, u, _, xfree, G = self.cspec.assemble(
                    CondensedParams(Ad=Ad, Bd=Bd, dd=dd, x0=x0, z=z_win,
                                    u_des=zeros(self.N, self.n_u)))
            else:
                P, q, A, l, u, _ = self.spec.assemble(LOCPParams(
                    Ad=Ad, Bd=Bd, dd=dd, x0=x0, xk=x_plan,
                    delta=self.delta0, omega=self.omega0, z=z_win,
                    zf=zeros(self.n_z), u_des=zeros(self.N, self.n_u)))
            if self.scaling_iters > 0:
                P, q, A, l, u, w0, y0, (d_s, e_s, c_s) = equilibrate_qp(
                    P, q, A, l, u, w0, y0, self.scaling_iters)
            w, y = self._solve_qp(P, q, A, l, u, w0, y0, fused)
            if self.scaling_iters > 0:
                w = d_s * w
                y = e_s * y / c_s[:, None]
            if condensed:
                u_plan = w.reshape(Bsz, self.N, self.n_u)
                x_plan = self.cspec.recover_x(xfree, G, w)
            else:
                x_plan, u_plan, _ = self.spec.split(w)
            warm = (w, y)
        return x_plan, u_plan, warm

    def _tick(self, x_p, ekf, x_plan, u_plan, k, noise):
        """One controller tick for every loop; `noise` (B, n_y) or None."""
        m = self.model
        Bsz = x_p.shape[0]
        mv = lambda M, v: (M @ v[..., None])[..., 0]
        x_bar, u_bar = x_plan[:, k], u_plan[:, k]
        # one launch: the plan point's index (its DARE gain), rows at the
        # plant state and the estimate only
        idx, A, Bm, d = m.select(torch.cat([x_bar, x_p, ekf.x], dim=0),
                                 index_only=Bsz)
        u = u_bar + mv(self.K_pts[idx[:Bsz]], ekf.x - x_bar)
        if self.u_clamp is not None:
            u = torch.clamp(u, self.u_clamp[0], self.u_clamp[1])
        p, e = slice(0, Bsz), slice(Bsz, 2 * Bsz)
        x_next = mv(A[p], x_p) + mv(Bm[p], u) + d[p]
        y = x_next @ m.C.T + m.y_ref
        if noise is not None:
            y = y + noise
        A_e = A[e]
        pred = EKFState(mv(A_e, ekf.x) + mv(Bm[e], u) + d[e],
                        A_e @ ekf.Sigma @ A_e.transpose(-1, -2) + self.W)
        ekf = ekf_correct(m, pred, y, self.V)
        z = x_next @ m.H.T + m.z_ref
        return x_next, ekf, z, u

    # ------------------------------------------------------------------
    def _build_loop(self, n_windows: int, noise_std: float, fused: bool):
        """The batched closed loop over n_windows replanning windows (see
        build_fused for its signature)."""
        N, N_rep, n_win = self.N, self.N_replan, int(n_windows)
        dev, dt = self.device, self.dtype
        n_var, n_con = self._qp_dims()

        def run(x_plant0, ekf_x0, z_target, noise=None, generator=None):
            t = lambda a: as_tensor(a, dt, dev)
            x_p, x_e, z_target = t(x_plant0), t(ekf_x0), t(z_target)
            Bsz = x_p.shape[0]
            if noise_std > 0:
                if noise is None:
                    gdev = generator.device if generator is not None else dev
                    noise = torch.randn((n_win, N_rep, Bsz, self.n_y),
                                        generator=generator, dtype=dt,
                                        device=gdev)
                noise = noise_std * t(noise)
            eye = torch.eye(self.n_x, dtype=dt, device=dev)
            ekf = EKFState(x_e, eye.expand(Bsz, -1, -1))
            x_plan = x_e[:, None].expand(-1, N + 1, -1)
            u_plan = torch.zeros((Bsz, N, self.n_u), dtype=dt, device=dev)
            warm = (torch.zeros((Bsz, n_var), dtype=dt, device=dev),
                    torch.zeros((Bsz, n_con), dtype=dt, device=dev))
            zs, us = [], []
            for w in range(n_win):
                # replan from the current belief
                x_plan, u_plan, warm = self._mpc_query_batched(
                    ekf.x, x_plan, u_plan, z_target[:, w], warm, fused)
                for k in range(N_rep):
                    x_p, ekf, z, u = self._tick(
                        x_p, ekf, x_plan, u_plan, k,
                        None if noise_std <= 0 else noise[w, k])
                    zs.append(z)
                    us.append(u)
            return {"z": torch.stack(zs, dim=1), "u": torch.stack(us, dim=1)}

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
