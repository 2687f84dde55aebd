"""Offline TPWL model building (the SOFA-free data pipeline).

Port of the JAX package's models/tpwl_build.py (sofacontrol/tpwl/
tpwl_utils.py TPWLSnapshotData, tpwl_config.py): sweep a recorded
trajectory, add a linearization point whenever the weighted (q, v) distance
to the current dictionary exceeds a threshold (eval_type='distance') or
whenever the partial dictionary's one-step prediction error does
(eval_type='dynamics'), and store the ROM-projected continuous affine
dynamics (A_c, B_c, d_c) of the plant's analytic Jacobians.

With eval_type='distance' the selection depends on the reduced states
alone, so the points are selected first on the host and their Jacobians
then computed and projected on the plant's device in batched calls, in
chunks whose dense (2n)^2 Jacobians stay under JACOBIAN_CHUNK_BYTES (the
JAX package jits one call a point). With eval_type='dynamics' each added
point's dynamics feed the next decision, so they are computed as the point
is added, and the criterion is numpy on (2r)^2 matrices, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.core import discretize as disc
from soft_robot_control_tpu_torch.core.packing import x2qv
from soft_robot_control_tpu_torch.models.tpwl import TPWLModel
from soft_robot_control_tpu_torch.rom.pod import POD
from soft_robot_control_tpu_torch.sim.fem_surrogate import FEMSurrogate
from soft_robot_control_tpu_torch.sim.snapshots import in_chunks
from soft_robot_control_tpu_torch.utils.device import as_tensor, resolve_device


@dataclass
class tpwl_config:
    """Mirrors sofacontrol/tpwl/tpwl_config.py defaults."""

    eval_type: str = "distance"  # 'distance' or 'dynamics'
    TPWL_weighting_factors: dict = field(default_factory=lambda: {"q": 10.0, "v": 1.0})
    TPWL_separate_calculation: bool = False
    TPWL_threshold: float = 1100.0
    # dynamics-eval options
    discr_method: str = "zoh"
    dist_weights: dict = field(default_factory=lambda: {"q": 1.0, "v": 0.0})
    output_based: bool = False
    dt: Optional[float] = None  # required for eval_type='dynamics'


def tpwl_distance_config(**kw) -> tpwl_config:
    return tpwl_config(eval_type="distance", **kw)


def tpwl_dynamics_config(**kw) -> tpwl_config:
    cfg = tpwl_config(eval_type="dynamics",
                      TPWL_weighting_factors={"q": 0.0, "v": 1.0},
                      TPWL_threshold=100000.0)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def reduced_affine_dynamics(plant: FEMSurrogate, rom: POD, x_full, u):
    """The plant's affine expansion at (x_full, u) projected to ROM
    coordinates (add_continuous_TPWL, tpwl_utils.py:263-277, with
    extract_AB, utils.py:251-286): A_r = V^T A V, B_r = V^T B and d_r =
    V^T f - A_r x_r - B_r u, so that the reduced model is tangent at the
    point, with V = kron(I2, U) never formed. x_full (..., 2n) and u
    (..., m) may carry leading batch axes; computed on the plant's device
    in its dtype. A plant with its own projection (the tet-FEM plant, whose
    dense Jacobian does not fit) is dispatched to it."""
    if hasattr(plant, "reduced_affine_dynamics"):
        return plant.reduced_affine_dynamics(rom, x_full, u)
    dev, dt = plant.device, plant.dtype
    x_full = as_tensor(x_full, dt, dev)
    u = as_tensor(u, dt, dev)
    A, B, d = plant.jacobians(x_full, u)
    n = rom.full_dim
    U = rom.U.to(device=dev, dtype=dt)
    Ut = U.T
    AV = torch.cat((A[..., :n] @ U, A[..., n:] @ U), dim=-1)
    A_r = torch.cat((Ut @ AV[..., :n, :], Ut @ AV[..., n:, :]), dim=-2)
    B_r = torch.cat((Ut @ B[..., :n, :], Ut @ B[..., n:, :]), dim=-2)
    f = plant.f(x_full, u)
    f_r = torch.cat((f[..., :n] @ U, f[..., n:] @ U), dim=-1)
    x_r = rom.project_x(x_full).to(dt)
    d_r = f_r - (A_r @ x_r[..., None])[..., 0] - (B_r @ u[..., None])[..., 0]
    return A_r, B_r, d_r


def _reduced_points(plant, rom, X, U):
    """reduced_affine_dynamics at the points X (k, 2n), U (k, m) in
    batched chunks (`in_chunks`); numpy (A_r, B_r, d_r), leading axis k."""
    return in_chunks(lambda x, u: reduced_affine_dynamics(plant, rom, x, u),
                     X, U)


def build_tpwl_model(plant: FEMSurrogate, rom: POD, x_traj, u_traj,
                     config: Optional[tpwl_config] = None,
                     params: Optional[dict] = None,
                     Cf=None, Hf=None,
                     discr_method: str = "zoh",
                     dynamics: str = "continuous",
                     x_next=None, dt: Optional[float] = None,
                     device="cuda") -> TPWLModel:
    """Sweep a recorded trajectory and build the TPWL dictionary on
    `device`.

    x_traj: (T, 2 n_f) full-order states; u_traj: (T, m) inputs applied
    (tensors or arrays).

    dynamics='continuous' stores projected continuous affine dynamics
    (the reference's add_continuous_TPWL). dynamics='discrete' also stores
    the projected discrete step map from plant.reduced_discrete_dynamics
    (add_discrete_TPWL, tpwl_utils.py:279-289); it needs `dt` and, for
    affine terms exact at the point, `x_next` (T, 2 n_f).

    Selection follows TPWLSnapshotData (tpwl_utils.py:156-260): the first
    point is always added; then with eval_type='distance' a point is added
    when the weighted distance of its reduced (q, v) to every saved point
    reaches TPWL_threshold, with eval_type='dynamics' when the partial
    dictionary's one-step prediction error (weighted over the q and v
    deltas) does.
    """
    config = config or tpwl_config()
    wq = config.TPWL_weighting_factors["q"]
    wv = config.TPWL_weighting_factors["v"]

    if dynamics not in ("continuous", "discrete"):
        raise ValueError(f"unknown dynamics mode {dynamics!r}")
    if dynamics == "discrete" and dt is None:
        raise ValueError("dynamics='discrete' requires dt")
    dev = resolve_device(device)
    pdev, pdt = plant.device, plant.dtype
    X = as_tensor(x_traj, pdt, pdev)
    Ut = as_tensor(u_traj, pdt, pdev)
    if Ut.dim() < 2:
        Ut = Ut.reshape(1, -1)
    u_np = Ut.cpu().numpy()
    # reduced coordinates of the whole sweep, in one projected batch
    xr = rom.project_x(X).cpu().numpy()
    qr, vr = x2qv(xr)
    r = rom.rom_dim
    dt = dt if dt is not None else getattr(config, "dt", None)

    sel_steps = []
    A_list, B_list, d_list = [], [], []
    Ad_list, Bd_list, dd_list = [], [], []
    if dynamics == "discrete":
        xn_r = (rom.project_x(as_tensor(x_next, pdt, pdev))
                if x_next is not None else None)

    def add_dynamics(i):
        A, B, d = _reduced_points(plant, rom, X[i:i + 1], Ut[i:i + 1])
        A_list.append(A[0])
        B_list.append(B[0])
        d_list.append(d[0])

    def add_discrete(i):
        # the dictionary carries both the continuous and the discrete
        # dynamics, like the reference's add_continuous/add_discrete pair
        xnr = (xn_r[i] if xn_r is not None
               else rom.project_x(plant.step(X[i], Ut[i], dt)))
        Ad, Bd, dd = plant.reduced_discrete_dynamics(rom, X[i], Ut[i], dt,
                                                     x_next_r=xnr)
        Ad_list.append(torch.as_tensor(Ad).cpu().numpy())
        Bd_list.append(torch.as_tensor(Bd).cpu().numpy())
        dd_list.append(torch.as_tensor(dd).cpu().numpy())

    eager = config.eval_type == "dynamics"

    def add(i):
        sel_steps.append(i)
        if eager:
            add_dynamics(i)
            if dynamics == "discrete":
                add_discrete(i)

    # numpy mirror of the partial TPWL model for the dynamics criterion,
    # as in the JAX package: (2r)^2 matrices on the host
    dwq = config.dist_weights["q"]
    dwv = config.dist_weights["v"]
    disc_cache = {}

    def predict_np(x_prev, u_prev):
        Q = qr[sel_steps]
        V = vr[sel_steps]
        d_sel = (dwq * np.linalg.norm(Q - x_prev[r:], axis=1)
                 + dwv * np.linalg.norm(V - x_prev[:r], axis=1))
        i_nn = int(np.argmin(d_sel))
        if dynamics == "discrete":
            Ad, Bd, dd_ = Ad_list[i_nn], Bd_list[i_nn], dd_list[i_nn]
        else:
            if i_nn not in disc_cache:
                disc_cache[i_nn] = tuple(
                    np.asarray(m) for m in disc.discretize_affine(
                        torch.as_tensor(A_list[i_nn]),
                        torch.as_tensor(B_list[i_nn]),
                        torch.as_tensor(d_list[i_nn]), dt,
                        method=config.discr_method))
            Ad, Bd, dd_ = disc_cache[i_nn]
        return Ad @ x_prev + Bd @ u_prev + dd_

    if config.eval_type == "dynamics" and dt is None:
        raise ValueError("dynamics eval_type requires config.dt")

    for i in range(xr.shape[0]):
        if not sel_steps:
            add(i)
            continue
        if config.eval_type == "dynamics":
            if i == 0 or np.all(u_np[i - 1] == 0):
                continue
            # predict the current reduced state from the previous one with
            # the partial TPWL model, compare prediction error
            x_pred = predict_np(xr[i - 1], u_np[i - 1])
            d_est = x_pred - xr[i - 1]
            d_true = xr[i] - xr[i - 1]
            dq_err = wq * np.linalg.norm(d_est[r:] - d_true[r:])
            dv_err = wv * np.linalg.norm(d_est[:r] - d_true[:r])
            if config.TPWL_separate_calculation:
                hit = (dq_err >= config.TPWL_threshold
                       or dv_err >= config.TPWL_threshold)
            else:
                hit = dq_err + dv_err >= config.TPWL_threshold
            if hit:
                add(i)
            continue
        qd = wq * np.linalg.norm(qr[sel_steps] - qr[i], axis=1)
        vd = wv * np.linalg.norm(vr[sel_steps] - vr[i], axis=1)
        if config.TPWL_separate_calculation:
            if qd.min() >= config.TPWL_threshold or vd.min() >= config.TPWL_threshold:
                add(i)
        else:
            if (qd + vd).min() >= config.TPWL_threshold:
                add(i)

    if not eager:
        A_list, B_list, d_list = _reduced_points(plant, rom, X[sel_steps],
                                                 Ut[sel_steps])
        if dynamics == "discrete":
            for i in sel_steps:
                add_discrete(i)

    params = params or {}
    dw = params.get("dist_weights") or {"q": 1.0, "v": 1.0}
    kw = {}
    if dynamics == "discrete":
        kw = dict(A_d=np.asarray(Ad_list), B_d=np.asarray(Bd_list),
                  d_d=np.asarray(dd_list), pre_discretized_dt=float(dt))
    model = TPWLModel(
        q=qr[sel_steps], v=vr[sel_steps], u=u_np[sel_steps],
        A_c=np.asarray(A_list), B_c=np.asarray(B_list), d_c=np.asarray(d_list),
        rom=rom, dist_w_q=dw["q"], dist_w_v=dw["v"],
        beta=params.get("beta_weighting"),
        discr_method=discr_method,
        tpwl_method=params.get("tpwl_method", "nn"), device=dev, **kw,
    )
    if Cf is not None:
        model = model.set_measurement_model(Cf)
    if Hf is not None:
        model = model.set_output_model(Hf)
    return model


def to_tpwl_dict(model: TPWLModel) -> dict:
    """Export a TPWLModel to the reference pickle layout
    (tpwl_utils.py:130-153 keys subset) for interchange, numpy arrays on
    the host. Discrete matrices travel along when the model carries
    them."""
    np_ = lambda a: a.cpu().numpy()
    out = {
        "q": np_(model.q), "v": np_(model.v), "u": np_(model.u),
        "A_c": np_(model.A_c), "B_c": np_(model.B_c), "d_c": np_(model.d_c),
        "rom_info": model.rom.get_info(),
        "dt": model.pre_discretized_dt if model.pre_discretized_dt else -1,
        "info": {"nbr_lin": str(model.num_points)},
    }
    if model.A_d is not None:
        out["A_d"] = np_(model.A_d)
        out["B_d"] = np_(model.B_d)
        out["d_d"] = np_(model.d_d)
    return out
