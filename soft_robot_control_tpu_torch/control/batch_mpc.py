"""Batched closed-loop MPC + EKF on a TPWL model.

B independent closed loops (TPWL model as plant, EKF, one condensed LOCP
solve per window) advance together along a leading batch axis. Each
replanning window does:

1. shift the last plan by N_replan steps;
2. fetch the nearest dictionary point's (A_d, B_d, d_d) for every plan
   state of every loop, in one launch of the TPWL select kernel;
3. assemble the condensed QP and Ruiz-equilibrate it;
4. run `rho_stages` stages of fixed-iteration ADMM, each one launch of the
   batched ADMM kernel with a fresh K^-1, with the per-loop rho folded
   into the constraint rows;
5. run N_replan ticks: DARE-gain feedback at the plan point, command
   clamp, plant step, EKF predict and correct. The three nearest-point
   lookups of a tick (plan point, plant state, estimate) go through one
   select launch.

The semantics are those of the JAX package's BatchMPC (real-time mode:
one LOCP per query, plan feedback with per-point DARE gains). Only the
condensed formulation is ported; the sparse one and `use_pallas=True`
raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.estimators.ekf import EKFState, ekf_correct
from soft_robot_control_tpu_torch.lqr.riccati import dare
from soft_robot_control_tpu_torch.ops.admm_batched import admm_batched
from soft_robot_control_tpu_torch.qp.admm import (RHO_MAX, RHO_MIN,
                                                  _ruiz_equilibrate)
from soft_robot_control_tpu_torch.qp.blocked import make_kinv
from soft_robot_control_tpu_torch.scp.locp_condensed import (CondensedParams,
                                                             CondensedSpec)
from soft_robot_control_tpu_torch.utils.device import as_tensor, resolve_device

_TODO = " is not ported yet (see ROADMAP.md, modules to port, item 8)"


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
    """Batched closed-loop MPC + EKF on a TPWL model (condensed LOCP)."""

    def __init__(self, model, Qz, R, N: int, dt: float, N_replan: int = 1,
                 U=None, dU=None, rho: float = 0.1, qp_iters: int = 100,
                 scp_iters: int = 1, W=None, V=None, Qk=None, Rk=None,
                 trust_region: bool = False, use_pallas: bool = False,
                 formulation: str = "condensed", scaling_iters: int = 6,
                 rho_stages: int = 1, dtype=torch.float32, device="cuda"):
        """
        model: TPWLModel with output and measurement models set; it is
               pre-discretized at dt, cast to dtype and moved to device.
        Qz, R: MPC cost. Qk, Rk: feedback-gain cost (default H'QzH, R).
        W, V: EKF covariances.
        """
        if formulation == "sparse":
            raise NotImplementedError("formulation='sparse'" + _TODO)
        if formulation != "condensed":
            raise ValueError(f"unknown formulation {formulation!r}")
        if use_pallas:
            raise NotImplementedError(
                "use_pallas=True (the sparse single-QP kernel) is not ported "
                "yet (see ROADMAP.md, TPU kernels to port, item 4)")
        if trust_region:
            raise NotImplementedError(
                "the condensed formulation eliminates x, so the trust "
                "region (a constraint on x) needs the sparse spec")
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
        # executed-command clamp: actuation limits on the final command
        # (the DARE feedback term lies outside the QP's constraint set)
        self.u_clamp = None
        if isinstance(U, HyperRectangle):
            self.u_clamp = (t(-U.b[1::2]), t(U.b[0::2]))
        self.cspec = CondensedSpec(self.N, m.H, Qz, R, U=U, dU=dU,
                                   dtype=dtype, device=dev)
        # all rows are inequalities: no equality-rho boost
        self.rho_vec_c = torch.full((self.cspec.n_con,), rho, dtype=dtype,
                                    device=dev)
        self.W = t(W) if W is not None else 100.0 * torch.eye(
            self.n_x, dtype=dtype, device=dev)
        self.V = t(V) if V is not None else torch.eye(
            self.n_y, dtype=dtype, device=dev)
        # per-TPWL-point DARE feedback gains (tpwl/controllers.py:239-246)
        Qk = t(Qk) if Qk is not None else m.H.T @ Qz @ m.H
        Rk = t(Rk) if Rk is not None else R
        self.K_pts, _ = dare(m.A_d, m.B_d, Qk, Rk)

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

    def _mpc_query_batched(self, x0, x_plan, u_plan, z_win, warm):
        """One condensed LOCP solve per loop, linearized along its shifted
        plan. z_win holds absolute targets (B, N+1, n_z)."""
        x_plan, u_plan = self._shift_plan(x_plan, u_plan)
        z_win = z_win - self.model.z_ref
        cspec = self.cspec
        Bsz = x0.shape[0]
        for _ in range(self.scp_iters):
            w0, y0 = warm
            Ad, Bd, dd = self._gather_traj(x_plan)
            P, q, A, l, u, _, xfree, G = cspec.assemble(CondensedParams(
                Ad=Ad, Bd=Bd, dd=dd, x0=x0, z=z_win,
                u_des=torch.zeros_like(u_plan)))
            if self.scaling_iters > 0:
                P, q, A, l, u, w0, y0, (d_s, e_s, c_s) = equilibrate_qp(
                    P, q, A, l, u, w0, y0, self.scaling_iters)
            w, y = admm_staged_batched(P, q, A, l, u, w0, y0, self.rho_vec_c,
                                       self.qp_iters, self.rho_stages)
            if self.scaling_iters > 0:
                w = d_s * w
                y = e_s * y / c_s[:, None]
            u_plan = w.reshape(Bsz, self.N, self.n_u)
            x_plan = cspec.recover_x(xfree, G, w)
            warm = (w, y)
        return x_plan, u_plan, warm

    def _tick(self, x_p, ekf, x_plan, u_plan, k, noise):
        """One controller tick for every loop; `noise` (B, n_y) or None."""
        m = self.model
        Bsz = x_p.shape[0]
        mv = lambda M, v: (M @ v[..., None])[..., 0]
        x_bar, u_bar = x_plan[:, k], u_plan[:, k]
        idx, A, Bm, d = m.select(torch.cat([x_bar, x_p, ekf.x], dim=0))
        u = u_bar + mv(self.K_pts[idx[:Bsz]], ekf.x - x_bar)
        if self.u_clamp is not None:
            u = torch.clamp(u, self.u_clamp[0], self.u_clamp[1])
        p, e = slice(Bsz, 2 * Bsz), slice(2 * Bsz, 3 * Bsz)
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
    def build_fused(self, n_windows: int, noise_std: float = 0.0):
        """The batched closed loop over n_windows replanning windows:

            run(x_plant0 (B,n_x), ekf_x0 (B,n_x),
                z_target (B,n_windows,N+1,n_z), noise=None, generator=None)
              -> {"z": (B, n_windows*N_replan, n_z),
                  "u": (B, n_windows*N_replan, n_u)}

        With noise_std > 0 the measurement noise is `noise_std` times
        `noise` (n_windows, N_replan, B, n_y) when given, else standard
        normal draws from `generator`.
        """
        N, N_rep, n_win = self.N, self.N_replan, int(n_windows)
        dev, dt = self.device, self.dtype

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
            warm = (torch.zeros((Bsz, self.cspec.n_var), dtype=dt, device=dev),
                    torch.zeros((Bsz, self.cspec.n_con), dtype=dt, device=dev))
            zs, us = [], []
            for w in range(n_win):
                # replan from the current belief
                x_plan, u_plan, warm = self._mpc_query_batched(
                    ekf.x, x_plan, u_plan, z_target[:, w], warm)
                for k in range(N_rep):
                    x_p, ekf, z, u = self._tick(
                        x_p, ekf, x_plan, u_plan, k,
                        None if noise_std <= 0 else noise[w, k])
                    zs.append(z)
                    us.append(u)
            return {"z": torch.stack(zs, dim=1), "u": torch.stack(us, dim=1)}

        return run

    def build(self, n_windows: int, noise_std: float = 0.0):
        """The single-trajectory closed loop, run as the batched one at
        B = 1:

            run(x_plant0 (n_x,), ekf_x0 (n_x,), z_target (n_windows,N+1,n_z),
                noise=None, generator=None) -> {"z": (T, n_z), "u": (T, n_u)}

        with T = n_windows*N_replan and `noise` (n_windows, N_replan, n_y).
        """
        fused = self.build_fused(n_windows, noise_std)

        def run(x_plant0, ekf_x0, z_target, noise=None, generator=None):
            t = lambda a: as_tensor(a, self.dtype, self.device)[None]
            if noise is not None:
                noise = as_tensor(noise)[:, :, None]
            logs = fused(t(x_plant0), t(ekf_x0), t(z_target), noise,
                         generator)
            return {k: v[0] for k, v in logs.items()}

        return run


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
