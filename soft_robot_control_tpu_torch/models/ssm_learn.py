"""Native SSM model learning: data-driven spectral-submanifold fitting.

The reference fits its SSM models in MATLAB SSMLearn (examples/diamond/
SSM_sysID.py exports decay data; a MATLAB script fits py_data.model.
{w_coeff, v_coeff, r_coeff, B, rd_coeff, Bd} into SSM_model.mat). This
module fits the same coefficient matrices from decay (and optionally
actuated) trajectories and returns the port's models/ssm.py:SSMModel, the
method of the JAX package's models/ssm_learn.py:

1. shift observations by the equilibrium z_ref and take the spectral
   subspace as the dominant left singular vectors V of the snapshots;
2. chart x = V' y (initial reduced coordinates);
3. parametrization y ~ W phi(x) by ridge regression on the grevlex monomial
   basis (ops/monomials.py, the ordering the .mat loader reads);
4. inverse chart x ~ V phi(y) by the same regression (v_coeff);
5. continuous reduced dynamics xdot ~ R phi_R(x), xdot from 4th-order
   finite differences, and discrete dynamics x+ ~ Rd phi_R(x);
6. input matrices B / Bd from actuated trajectories, by regressing the
   decay-dynamics residual on u, or jointly with the dynamics.

Precision: the fit runs on the host in numpy float64, as in the JAX
package. The regressions are small (thousands of samples by about a
hundred monomials) but ill-conditioned: normal equations of cubic
monomials lose about twice the features' condition number in digits, and
in float32 every ridge candidate fails. The model is then built on the
caller's device in the caller's dtype, where inference runs.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from soft_robot_control_tpu_torch.models.ssm import SSMModel
from soft_robot_control_tpu_torch.ops.monomials import monomial_exponents
from soft_robot_control_tpu_torch.utils.device import to_numpy


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def delay_embed(y, n_delay: int):
    """Delay-embed a trajectory (T, p) -> (T - n_delay, p*(n_delay+1)).

    Row t holds [y_t, y_{t-1}, ..., y_{t-n_delay}] — newest first, matching
    the reference's assembly of the delay-embedded observable used for the
    Diamond SSM (6 = 3 positions x 2 embeddings). Numpy f64 out."""
    y = np.asarray(to_numpy(y), np.float64)
    if n_delay == 0:
        return y
    T = y.shape[0]
    cols = [y[n_delay - d:T - d] for d in range(n_delay + 1)]
    return np.concatenate(cols, axis=1)


def differentiate(x, dt: float):
    """4th-order central finite differences along axis 0 (2nd-order one-sided
    at the edges): the derivative estimate SSMLearn feeds its dynamics fit.
    x: (T, n) -> (T, n), numpy f64."""
    x = np.asarray(to_numpy(x), np.float64)
    T = x.shape[0]
    if T < 5:
        return np.gradient(x, dt, axis=0)
    interior = (x[:-4] - 8.0 * x[1:-3] + 8.0 * x[3:-1] - x[4:]) / (12.0 * dt)
    first = np.stack([
        (-3.0 * x[0] + 4.0 * x[1] - x[2]) / (2.0 * dt),
        (x[2] - x[0]) / (2.0 * dt),
    ])
    last = np.stack([
        (x[-1] - x[-3]) / (2.0 * dt),
        (3.0 * x[-1] - 4.0 * x[-2] + x[-3]) / (2.0 * dt),
    ])
    return np.concatenate([first, interior, last], axis=0)


def _phi(x, exps):
    """Numpy monomial evaluation: x (..., dim) -> (..., n_mono), f64."""
    x = np.asarray(x, np.float64)
    e = np.asarray(exps, np.float64)
    pw = np.where(e > 0, x[..., None, :] ** e, 1.0)
    return np.prod(pw, axis=-1)


def _ridge_fit(Phi, Y, lam: float):
    """min_W ||W Phi - Y||^2 + lam ||W S||^2 -> W (n_out, n_feat).

    Phi: (n_feat, n_samp); Y: (n_out, n_samp). The ridge is Jacobi-scaled
    (S = diag row norms of Phi) so one lam works across monomial degrees."""
    Phi = np.asarray(Phi, np.float64)
    Y = np.asarray(Y, np.float64)
    G = Phi @ Phi.T
    s = np.diagonal(G)
    reg = lam * np.where(s > 0, s, 1.0)
    Gr = G + np.diag(reg)
    RHS = Phi @ Y.T
    return scipy.linalg.solve(Gr, RHS, assume_a="pos").T


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------
def learn_ssm(decay_trajs, dt: float, state_dim: int, SSM_order: int = 3,
              ROM_order: int = 3, z_ref=None, n_delay: int = 0,
              actuated_trajs=None, input_trajs=None, ridge: float = 1e-8,
              joint_fit: bool = False, discr_method: str = "fe",
              dtype=torch.float64, device="cuda") -> SSMModel:
    """Fit an SSMModel from decay trajectories (numpy arrays or tensors)
    on the host in float64; the model is built on `device` in `dtype`.

    decay_trajs: list of (T_i, p) observed decays toward the equilibrium
        (raw outputs; delay embedding applied here when n_delay > 0).
    dt: sample time.
    state_dim: SSM (reduced) dimension; must equal the embedded observable
        dimension convention of models/ssm.py only in its output tables —
        here the embedded dim p*(n_delay+1) defines output_dim.
    z_ref: equilibrium in embedded coordinates. Default: mean of the final
        sample of each decay — ONLY valid if the decays have settled;
        weakly-damped data biases this estimate and with it every fit, so
        prefer passing a measured rest position (the reference measures it
        explicitly: examples/hardware/calibration.py rest_qv).
    actuated_trajs / input_trajs: optional matched lists of observed
        trajectories under known inputs u (T_i, m) for the B / Bd fit.
    ridge: Jacobi-scaled ridge weight for every regression. Pass a SEQUENCE
        of candidates to select the dynamics-fit weight by trajectory
        holdout: thin-manifold data (the common soft-robot case: the decays
        barely leave a low-dimensional tube of the reduced space) makes the
        unregularized cubic fit blow up off-data, and no single default
        works across systems. Selection minimizes the multi-step rollout
        error of the candidate fit on held-out decays, rejecting non-finite
        (unstable) fits outright; the winning weight then refits on all
        trajectories.

    Returns an SSMModel carrying both continuous (r_coeff, B_r) and discrete
    (rd_coeff, Bd_r, Ts=dt) dynamics.
    """
    Ys = [delay_embed(to_numpy(tr), n_delay) for tr in decay_trajs]
    n_obs = Ys[0].shape[1]

    if z_ref is None:
        z_ref = np.mean([y[-1] for y in Ys], axis=0)
    z_ref = np.asarray(to_numpy(z_ref), np.float64).reshape(-1)
    Ys = [y - z_ref[None, :] for y in Ys]

    # 1. spectral subspace: dominant left singular vectors of all snapshots
    snaps = np.concatenate(Ys, axis=0).T               # (n_obs, n_samp)
    V, _, _ = np.linalg.svd(snaps, full_matrices=False)
    V = V[:, :state_dim]                               # (n_obs, state_dim)

    # 2. reduced coordinates of every decay sample
    Xs = [y @ V for y in Ys]                           # each (T_i, state_dim)
    X_all = np.concatenate(Xs, axis=0)                 # (n_samp, state_dim)
    Y_all = np.concatenate(Ys, axis=0)

    ssm_exps = monomial_exponents(n_obs, SSM_order)
    rom_exps = monomial_exponents(state_dim, ROM_order)

    # 3. parametrization y ~ w_coeff phi(x); 4. chart x ~ v_coeff phi(y).
    # models/ssm.py evaluates both with the output_dim exponent table, which
    # requires n_obs == state_dim + padding otherwise; SSMLearn's Diamond
    # artifact satisfies n_obs == state_dim (6 == 6) and we enforce it here.
    if n_obs != state_dim:
        raise ValueError(
            f"embedded observable dim {n_obs} != state_dim {state_dim}: "
            "models/ssm.py's C_map/W_map share one monomial table "
            "(ssm.py:115-121), so choose n_delay such that "
            "p*(n_delay+1) == state_dim")
    lam_list = (list(ridge) if np.ndim(ridge) > 0 else [float(ridge)])
    lam_geo = float(np.exp(np.mean(np.log(lam_list))))

    Phi_x = _phi(X_all, ssm_exps).T                    # (n_feat, n_samp)
    w_coeff = _ridge_fit(Phi_x, Y_all.T, lam_geo)
    Phi_y = _phi(Y_all, ssm_exps).T
    v_coeff = _ridge_fit(Phi_y, X_all.T, lam_geo)

    # 5. reduced dynamics, with optional holdout selection of the ridge
    # weight (see the `ridge` docstring)
    def fit_dynamics(trajs, lam):
        Xa = np.concatenate(trajs, axis=0)
        Xd = np.concatenate([differentiate(x, dt) for x in trajs], axis=0)
        r = _ridge_fit(_phi(Xa, rom_exps).T, Xd.T, lam)  # xdot ~ R phi(x)
        X0 = np.concatenate([x[:-1] for x in trajs], axis=0)
        X1 = np.concatenate([x[1:] for x in trajs], axis=0)
        rd = _ridge_fit(_phi(X0, rom_exps).T, X1.T, lam)  # x+ ~ Rd phi(x)
        return r, rd

    def rollout_err(r, rd, trajs):
        """Multi-step prediction error on held-out reduced trajectories:
        discrete map iteration + RK4 of the continuous field. Unstable fits
        go non-finite (numpy errstate-silenced overflow) and are rejected."""
        def one(traj):
            # validate over (nearly) the full decay: instabilities often
            # only blow up beyond the first ~100 steps
            K = min(500, traj.shape[0] - 1)
            f = lambda x: r @ _phi(x, rom_exps)
            xd = traj[0].copy()
            xc = traj[0].copy()
            err = 0.0
            with np.errstate(over="ignore", invalid="ignore"):
                for k in range(K):
                    xd = rd @ _phi(xd, rom_exps)
                    k1 = f(xc); k2 = f(xc + 0.5 * dt * k1)
                    k3 = f(xc + 0.5 * dt * k2); k4 = f(xc + dt * k3)
                    xc = xc + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
                    ref = traj[k + 1]
                    err += np.mean((xd - ref) ** 2) + np.mean((xc - ref) ** 2)
                    if not (np.all(np.isfinite(xd)) and np.all(np.isfinite(xc))):
                        return np.inf
            return err / K
        errs = [one(tr) for tr in trajs]
        e = float(np.mean(errs))
        return e if np.isfinite(e) else np.inf

    lam_dyn = lam_list[0]
    if len(lam_list) == 1 or len(Xs) < 2:
        r_coeff, rd_coeff = fit_dynamics(Xs, lam_dyn)
    else:
        n_val = max(1, len(Xs) // 4)
        fit_trajs, val_trajs = Xs[:-n_val], Xs[-n_val:]
        scores = []
        for lam in lam_list:
            r_c, rd_c = fit_dynamics(fit_trajs, lam)
            scores.append(rollout_err(r_c, rd_c, val_trajs))
        if not np.isfinite(min(scores)):
            raise RuntimeError(
                "every ridge candidate produced an unstable dynamics fit; "
                "widen the candidate list or collect richer decay data")
        lam_dyn = lam_list[int(np.argmin(scores))]
        r_coeff, rd_coeff = fit_dynamics(Xs, lam_dyn)

    # 6. input matrices from actuated data.
    # joint_fit=True refits [R | B] in ONE regression over decays AND
    # actuated trajectories (features [phi(x); u]): the two-stage residual
    # fit evaluates the decay-trained cubic R phi(x) along FORCED
    # trajectories, whose (x, xdot) combinations sit outside the decay
    # envelope — the extrapolated residual is garbage and so is the B
    # regressed on it (observed: a trunk model whose 1-second 200 mN
    # response was meters). Jointly fitted dynamics stay consistent on the
    # union of both data families.
    m_in = 0
    B_r = None
    Bd_r = None
    if actuated_trajs is not None:
        assert input_trajs is not None and len(actuated_trajs) == len(
            input_trajs), "actuated_trajs and input_trajs must pair up"
        Xu, Us = [], []
        for tr, u in zip(actuated_trajs, input_trajs):
            ye = delay_embed(to_numpy(tr), n_delay) - z_ref[None, :]
            Xu.append(ye @ V)
            # delay embedding drops the first n_delay samples of y; align u
            Us.append(np.asarray(to_numpy(u), np.float64)[n_delay:])
        m_in = int(Us[0].shape[1])
        if joint_fit:
            n_feat = rom_exps.shape[0]
            # continuous: [xdot_decay; xdot_act] ~ [phi, u] [R; B]'
            Xa_dec = np.concatenate(Xs, axis=0)
            Xd_dec = np.concatenate([differentiate(x, dt) for x in Xs],
                                    axis=0)
            U_dec = np.zeros((Xa_dec.shape[0], m_in))
            Xa_act = np.concatenate(Xu, axis=0)
            Xd_act = np.concatenate([differentiate(x, dt) for x in Xu],
                                    axis=0)
            U_act = np.concatenate([u[:x.shape[0]]
                                    for x, u in zip(Xu, Us)], axis=0)
            Phi = np.concatenate([
                np.concatenate([_phi(Xa_dec, rom_exps), U_dec], axis=1),
                np.concatenate([_phi(Xa_act, rom_exps), U_act], axis=1)],
                axis=0)
            Y = np.concatenate([Xd_dec, Xd_act], axis=0)
            RB = _ridge_fit(Phi.T, Y.T, lam_dyn)
            r_coeff, B_r = RB[:, :n_feat], RB[:, n_feat:]
            # discrete: x+ ~ [phi(x), u] [Rd; Bd]'
            X0d = np.concatenate([x[:-1] for x in Xs], axis=0)
            X1d = np.concatenate([x[1:] for x in Xs], axis=0)
            X0a = np.concatenate([x[:-1] for x in Xu], axis=0)
            X1a = np.concatenate([x[1:] for x in Xu], axis=0)
            U0a = np.concatenate([u[:x.shape[0] - 1]
                                  for x, u in zip(Xu, Us)], axis=0)
            Phi_d = np.concatenate([
                np.concatenate([_phi(X0d, rom_exps),
                                np.zeros((X0d.shape[0], m_in))], axis=1),
                np.concatenate([_phi(X0a, rom_exps), U0a], axis=1)], axis=0)
            Y_d = np.concatenate([X1d, X1a], axis=0)
            RBd = _ridge_fit(Phi_d.T, Y_d.T, lam_dyn)
            rd_coeff, Bd_r = RBd[:, :n_feat], RBd[:, n_feat:]
        else:
            # continuous: (xdot - R phi(x)) ~ B u; discrete analog for Bd
            resid_c, resid_d, U_c, U_d = [], [], [], []
            for xu, u in zip(Xu, Us):
                xd = differentiate(xu, dt)
                resid_c.append(xd - _phi(xu, rom_exps) @ r_coeff.T)
                U_c.append(u[:xu.shape[0]])
                resid_d.append(xu[1:] - _phi(xu[:-1], rom_exps) @ rd_coeff.T)
                U_d.append(u[:xu.shape[0] - 1])
            Rc = np.concatenate(resid_c, axis=0)
            Uc = np.concatenate(U_c, axis=0)
            Rd_ = np.concatenate(resid_d, axis=0)
            Ud = np.concatenate(U_d, axis=0)
            B_r = _ridge_fit(Uc.T, Rc.T, lam_dyn)
            Bd_r = _ridge_fit(Ud.T, Rd_.T, lam_dyn)
    if B_r is None:
        B_r = np.zeros((state_dim, max(m_in, 1)))
        Bd_r = np.zeros((state_dim, max(m_in, 1)))

    return SSMModel(
        w_coeff=w_coeff, v_coeff=v_coeff, r_coeff=r_coeff, B_r=B_r,
        rd_coeff=rd_coeff, Bd_r=Bd_r, z_ref=z_ref, state_dim=state_dim,
        input_dim=int(B_r.shape[1]), output_dim=n_obs, SSM_order=SSM_order,
        ROM_order=ROM_order, Ts=float(dt), discrete=False,
        discr_method=discr_method, dtype=dtype, device=device)


def to_mat_dict(model: SSMModel) -> dict:
    """An SSMModel in the py_data layout SSMLearn writes (SSM_model.mat,
    read by models/ssm.py:from_mat through scipy.io), numpy arrays, so
    that natively trained models work with the reference's tooling and
    the JAX package."""
    a = lambda t: np.asarray(to_numpy(t))
    return {"py_data": {
        "model": {
            "w_coeff": a(model.w_coeff),
            "v_coeff": a(model.v_coeff),
            "r_coeff": a(model.r_coeff),
            "B": a(model.B_r),
            "rd_coeff": a(model.rd_coeff),
            "Bd": a(model.Bd_r),
            "Ts": model.Ts,
            # beyond the reference's layout: the equilibrium, so that the
            # artifact stands alone (the reference reads it from
            # rest_qv.pkl)
            "z_ref": a(model.z_ref),
        },
        "params": {
            "state_dim": model.state_dim,
            "input_dim": model.input_dim,
            "output_dim": model.output_dim,
            "SSM_order": model.SSM_order,
            "ROM_order": model.ROM_order,
        },
    }}


def save_mat(model: SSMModel, path: str) -> None:
    """Write an SSM_model.mat that both packages' from_mat and the
    reference's loader read."""
    from scipy.io import savemat

    savemat(path, to_mat_dict(model))
