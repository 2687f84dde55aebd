"""Iterative LQR (sofacontrol/lqr/ilqr.py): quadratic output-space
tracking cost 0.5 (z - z*)'Q(z - z*) with input (or delta-input) cost,
forward simulation with u = u_bar + alpha k + K (x - x_bar), backward
Riccati-like recursion with a positive-definiteness check and (state or
input) regularization, line search on the cost-decrease ratio, convergence
on the cost delta. Hyperparameters as sofacontrol/lqr/config.py.

The forward pass and the backward recursion are loops over the horizon on
tensors, on the model's device in its dtype. Each forward step calls the
model's `get_jacobians` on one state: on a TPWL model, one launch of the
select kernel a step. The backward pass checks positive definiteness of
all the steps' regularized Q_uu in one batched eigenvalue call after the
loop, and the host reads the pass's cost and that flag. Line search and
regularization run on the host, as in the reference.

Works for models with a linear output map z = H x + z_ref (the
restriction the reference notes at ilqr.py:184-185).
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.utils.device import as_tensor, to_numpy


class iLQRConfig:
    """Defaults identical to sofacontrol/lqr/config.py."""

    def __init__(self):
        self.max_iter = 50
        self.epsilon = 0.1
        self.include_input_var_constraint = True
        self.do_linesearch = True
        self.regularize = True
        self.alpha0 = 1.0
        self.alpha_scaling = 0.5
        self.improv_lb = 1e-4
        self.improv_ub = 100
        self.alpha_min = 5e-2
        self.counter_limit = 5
        self.rho0 = 0.0
        self.drho0 = 0.0
        self.rho_scaling = 1.5
        self.rho_increase_fp = 10.0
        self.rho_max = 1e5
        self.rho_min = 1e-3
        self.state_regularization = True


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class iLQR:
    def __init__(self, dt, model, cost_params, planning_horizon, **kwargs):
        self.params = kwargs.pop("config", None) or iLQRConfig()
        self.dt = dt
        self.model = model
        self.planning_horizon = int(planning_horizon)
        self.cost_params = cost_params
        self.state_dim = model.get_state_dim()
        self.input_dim = model.get_input_dim()
        self.z_target = None
        self.u_last = np.zeros(self.input_dim)

        self.H = torch.as_tensor(model.H)
        dtype, dev = self.H.dtype, self.H.device
        self._t = lambda a: as_tensor(a, dtype, dev)
        self.z_ref = self._t(model.z_ref)
        self.Q = self._t(cost_params.Q)
        self.Qf = self._t(cost_params.Qf if cost_params.Qf is not None
                          else cost_params.Q)
        self.R = self._t(cost_params.R)

    # ---------------- forward pass ------------------------------------
    def _forward(self, x0, x_prev, u_prev, K, k, alpha, z_target, u_last):
        """Roll the model under u_t = u_prev_t + alpha k_t + K_t (x -
        x_prev_t). Returns (x (T+1, n), u (T, m), cost (0-dim tensor),
        A, B, d) with the Jacobians at every (x_t, u_t)."""
        H, z_ref, Q, R = self.H, self.z_ref, self.Q, self.R
        use_du = self.params.include_input_var_constraint
        x, u_p_step = x0, u_last
        cost = torch.zeros((), dtype=H.dtype, device=H.device)
        xs, us, As, Bs, ds = [], [], [], [], []
        for t in range(u_prev.shape[0]):
            u_t = u_prev[t] + alpha * k[t] + _mv(K[t], x - x_prev[t])
            dz = _mv(H, x) + z_ref - z_target[t]
            c = 0.5 * dz @ Q @ dz
            if use_du:
                du = u_t - u_p_step
                c = c + 0.5 * du @ R @ du
            else:
                c = c + 0.5 * u_t @ R @ u_t
            A, B, d = self.model.get_jacobians(x, dt=self.dt, u=u_t)
            xs.append(x)
            us.append(u_t)
            As.append(A)
            Bs.append(B)
            ds.append(d)
            x = _mv(A, x) + _mv(B, u_t) + d
            u_p_step = u_t
            cost = cost + c
        dzT = _mv(H, x) + z_ref - z_target[-1]
        cost = cost + 0.5 * dzT @ self.Qf @ dzT
        xs.append(x)
        return (torch.stack(xs), torch.stack(us), cost, torch.stack(As),
                torch.stack(Bs), torch.stack(ds))

    # ---------------- backward pass -----------------------------------
    def _backward(self, x, u, A, B, z_target, u_last, rho):
        """The reversed recursion. Returns (K, k, Q_u, Q_uu) ordered
        forward in time and the regularized Q_uu of every step, whose
        positive definiteness the caller checks."""
        H, z_ref, Q, R, Qf = self.H, self.z_ref, self.Q, self.R, self.Qf
        use_du = self.params.include_input_var_constraint
        n, m = self.state_dim, self.input_dim
        Ht = H.T
        HQ = Ht @ Q
        c_xx = Ht @ Q @ H
        I_n = torch.eye(n, dtype=H.dtype, device=H.device)
        I_m = torch.eye(m, dtype=H.dtype, device=H.device)

        zT = _mv(H, x[-1]) + z_ref
        p = _mv(Ht @ Qf, zT - z_target[-1])
        P = Ht @ Qf @ H
        T = u.shape[0]
        u_prev_seq = torch.cat((u_last[None], u[:-1]), dim=0) \
            if use_du else torch.zeros_like(u)
        out = [[None] * T for _ in range(5)]
        for t in reversed(range(T)):
            A_t, B_t = A[t], B[t]
            At, Bt = A_t.T, B_t.T
            dz = _mv(H, x[t]) + z_ref - z_target[t]
            c_x = _mv(HQ, dz)
            c_u = _mv(R, u[t] - u_prev_seq[t]) if use_du else _mv(R, u[t])
            c_uu = R
            Q_x = c_x + _mv(At, p)
            Q_u = c_u + _mv(Bt, p)
            Q_xx = c_xx + At @ P @ A_t
            Q_uu = c_uu + Bt @ P @ B_t
            Q_ux = Bt @ P @ A_t
            if self.params.state_regularization:
                Preg = P + rho * I_n
                Q_uu_t = c_uu + Bt @ Preg @ B_t
                Q_ux_t = Bt @ Preg @ A_t
            else:
                Q_uu_t = Q_uu + rho * I_m
                Q_ux_t = Q_ux
            Q_uu_t_inv = torch.linalg.inv_ex(Q_uu_t)[0]
            K_t = -Q_uu_t_inv @ Q_ux_t
            k_t = -_mv(Q_uu_t_inv, Q_u)
            Kt = K_t.T
            p = Q_x + _mv(Kt @ Q_uu, k_t) + _mv(Kt, Q_u) + _mv(Q_ux.T, k_t)
            P = Q_xx + Kt @ Q_uu @ K_t + Kt @ Q_ux + Q_ux.T @ K_t
            # re-symmetrize: roundoff asymmetry in K'Quu K + K'Qux + Qux'K
            # amplifies through A'PA and overflows the recursion
            P = 0.5 * (P + P.T)
            for lst, v in zip(out, (K_t, k_t, Q_u, Q_uu, Q_uu_t)):
                lst[t] = v
        return [torch.stack(v) for v in out]

    # ------------------------------------------------------------------
    def set_target(self, z_target):
        self.z_target = np.asarray(z_target, float).copy()

    def set_u_last(self, u_last):
        self.u_last = np.asarray(u_last, float).copy()

    def update_regularization(self, increase=True):
        p = self.params
        if increase:
            self.drho = max(self.drho * p.rho_scaling, p.rho_scaling)
            self.rho = max(self.rho * self.drho, p.rho_min)
            if self.rho > p.rho_max:
                self.rho = p.rho_max
        else:
            self.drho = min(self.drho / p.rho_scaling, 1.0 / p.rho_scaling)
            self.rho = self.rho * self.drho
            if self.rho <= p.rho_min:
                self.rho = p.rho_min

    def _run_backward(self, x, u, A, B, z_t, u_last):
        """Backward pass, escalating regularization until all steps are PD
        (reference semantics: restart-on-non-PD, ilqr.py:276-287). The
        minimum eigenvalue of every step's regularized Q_uu is computed in
        one call and read once a pass."""
        while True:
            K, k, Qu, Quu, Quu_t = self._backward(x, u, A, B, z_t, u_last,
                                                  self.rho)
            # a non-finite Q_uu counts as not positive definite (the JAX
            # eigenvalues are NaN there); -I stands in for it
            finite = torch.isfinite(Quu_t).all(dim=(-1, -2))[:, None, None]
            I_m = torch.eye(Quu_t.shape[-1], dtype=Quu_t.dtype,
                            device=Quu_t.device)
            Quu_t = torch.where(finite, Quu_t, -I_m)
            all_pd = bool((torch.linalg.eigvalsh(Quu_t)[:, 0] > 0).all())
            if all_pd or not self.params.regularize or \
                    self.rho >= self.params.rho_max:
                break
            self.update_regularization(increase=True)
        self.update_regularization(increase=False)
        return K, k, Qu, Quu

    def ilqr_computation(self, x0, u_warmstart=None):
        """Main loop (ilqr.py:27-107 semantics). Returns (x_bar, u_bar, K)
        as numpy arrays."""
        p = self.params
        self.rho = p.rho0
        self.drho = p.drho0
        failed_update_counter = 0
        T = self.planning_horizon
        t = self._t

        x_prev = torch.zeros((T + 1, self.state_dim), dtype=self.H.dtype,
                             device=self.H.device)
        x_prev[0] = t(x0)
        if u_warmstart is None:
            u_warmstart = np.zeros((T, self.input_dim))

        zeros_K = t(np.zeros((T, self.input_dim, self.state_dim)))
        zeros_k = t(np.zeros((T, self.input_dim)))
        z_t = t(self.z_target)
        u_last = t(self.u_last)

        x, u, cost, A, B, d = self._forward(x_prev[0], x_prev, t(u_warmstart),
                                            zeros_K, zeros_k, 1.0, z_t,
                                            u_last)
        cost = float(cost)

        is_converged = False
        nbr_iter = 0
        K = zeros_K

        while not is_converged and nbr_iter <= p.max_iter:
            K, k, Q_u, Q_uu = self._run_backward(x, u, A, B, z_t, u_last)
            prev_cost = cost
            alpha = p.alpha0
            improved = False
            failed = False

            while not improved and not failed:
                improved = True
                x_tmp, u_tmp, cost_tmp, A_tmp, B_tmp, d_tmp = self._forward(
                    x[0], x, u, K, k, alpha, z_t, u_last)
                cost_tmp = float(cost_tmp)

                delta_cost = float(torch.sum(
                    alpha * torch.einsum("ti,ti->t", k, Q_u)
                    + 0.5 * alpha**2 * torch.einsum("ti,tij,tj->t", k, Q_uu,
                                                    k)))

                # a full step can drive the rollout outside the model's
                # stability envelope -> inf/NaN cost; NaN comparisons are
                # all False and would accept the trajectory, so non-finite
                # costs are rejected explicitly and the step shrinks
                if not np.isfinite(cost_tmp):
                    alpha = p.alpha_scaling * alpha
                    improved = False
                    if alpha < p.alpha_min:
                        self.update_regularization(increase=True)
                        self.rho += p.rho_increase_fp
                        failed = True
                    continue

                if p.do_linesearch:
                    decrease_ratio = (cost_tmp - prev_cost) / delta_cost \
                        if delta_cost != 0 else np.inf
                    if decrease_ratio <= p.improv_lb or \
                            decrease_ratio > p.improv_ub:
                        alpha = p.alpha_scaling * alpha
                        improved = False
                        if alpha < p.alpha_min:
                            self.update_regularization(increase=True)
                            self.rho += p.rho_increase_fp
                            failed = True

            if not failed:
                x, u, cost = x_tmp, u_tmp, cost_tmp
                A, B, d = A_tmp, B_tmp, d_tmp
                is_converged = (prev_cost - cost) < p.epsilon and \
                    (prev_cost - cost) >= 0
                failed_update_counter = 0
            else:
                failed_update_counter += 1
                if failed_update_counter >= p.counter_limit:
                    is_converged = True

            nbr_iter += 1

        return to_numpy(x), to_numpy(u), to_numpy(K)
