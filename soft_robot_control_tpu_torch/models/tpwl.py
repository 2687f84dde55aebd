"""Trajectory-PieceWise-Linear (TPWL) reduced dynamics.

A dictionary of P linearization points {q, v, u, A_c, B_c, d_c} stacked
into tensors, nearest-point selection by weighted distance,
pre-discretization of the whole dictionary in one batched call, and the
ROM-projected output and measurement maps C = Cf V, H = Hf V, the
Jacobians at a batch of states in 'nn' (nearest point) or 'weighting'
(exponentially weighted blend) mode, and rollouts.

Every nearest-point lookup by direct differences (`select`,
`get_jacobians` in 'nn' mode, `rollout`, `rollout_batch` in its 'exact'
and 'pallas' modes) goes through the TPWL select kernel
(ops/tpwl_select.py): one launch for all the states of a call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.core import discretize as disc
from soft_robot_control_tpu_torch.core.packing import qv2x, x2qv
from soft_robot_control_tpu_torch.rom.pod import POD
from soft_robot_control_tpu_torch.utils.device import as_tensor
from soft_robot_control_tpu_torch.utils.timing import span

DISCR_METHOD_DEFAULT = "fe"
TPWL_METHOD_DEFAULT = "nn"


class TPWLModel:
    """Stacked TPWL dictionary + ROM + output maps; every tensor lies on
    one device. Methods that change the model return a new one."""

    _children = ("q", "v", "u", "A_c", "B_c", "d_c", "A_d", "B_d", "d_d",
                 "C", "y_ref", "H", "z_ref", "dist_w_q", "dist_w_v", "beta",
                 "rom")

    def __init__(self, q, v, u, A_c, B_c, d_c, rom: POD,
                 A_d=None, B_d=None, d_d=None,
                 C=None, y_ref=None, H=None, z_ref=None,
                 dist_w_q=1.0, dist_w_v=1.0, beta=None,
                 discr_method: str = DISCR_METHOD_DEFAULT,
                 tpwl_method: str = TPWL_METHOD_DEFAULT,
                 pre_discretized_dt: Optional[float] = None,
                 device="cuda"):
        from soft_robot_control_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        t = lambda a: None if a is None else as_tensor(a, device=dev)
        self.q, self.v, self.u = t(q), t(v), t(u)
        self.A_c, self.B_c, self.d_c = t(A_c), t(B_c), t(d_c)
        self.A_d, self.B_d, self.d_d = t(A_d), t(B_d), t(d_d)
        self.C, self.y_ref, self.H, self.z_ref = t(C), t(y_ref), t(H), t(z_ref)
        self.dist_w_q = float(dist_w_q)
        self.dist_w_v = float(dist_w_v)
        self.beta = None if beta is None else float(beta)
        self.rom = rom
        self.discr_method = discr_method
        self.tpwl_method = tpwl_method
        self.pre_discretized_dt = pre_discretized_dt

    def _replace(self, **kw) -> "TPWLModel":
        obj = TPWLModel.__new__(TPWLModel)
        obj.__dict__.update(self.__dict__)
        obj.__dict__.update(kw)
        return obj

    @property
    def device(self):
        return self.q.device

    def to(self, dtype=None, device=None) -> "TPWLModel":
        """Copy with every floating dictionary and output tensor cast to
        `dtype` and/or moved to `device` (the ROM basis keeps its own)."""
        kw = {}
        for k in self._children:
            a = getattr(self, k)
            if torch.is_tensor(a):
                kw[k] = a.to(device=device, dtype=dtype)
        return self._replace(**kw)

    # dims --------------------------------------------------------------
    @property
    def num_points(self) -> int:
        return self.q.shape[0]

    @property
    def state_dim(self) -> int:
        return 2 * self.q.shape[1]

    @property
    def input_dim(self) -> int:
        return self.u.shape[1]

    @property
    def output_dim(self):
        return None if self.H is None else self.H.shape[0]

    @property
    def meas_dim(self):
        return None if self.C is None else self.C.shape[0]

    # the reference API's accessors, which the controllers call
    def get_state_dim(self):
        return self.state_dim

    def get_input_dim(self):
        return self.input_dim

    def get_output_dim(self):
        return self.output_dim

    def get_meas_dim(self):
        return self.meas_dim

    nonlinear_observer = False

    # output / measurement models ----------------------------------------
    def set_measurement_model(self, Cf):
        """C = Cf V, y_ref = Cf x_ref, V never materialized."""
        Cf = _dense(Cf)
        C = self.rom.project_output_matrix(Cf)
        return self._replace(C=C, y_ref=_apply(Cf, self.rom.x_ref, C.dtype))

    def set_output_model(self, Hf):
        Hf = _dense(Hf)
        H = self.rom.project_output_matrix(Hf)
        return self._replace(H=H, z_ref=_apply(Hf, self.rom.x_ref, H.dtype))

    def zfyf_to_zy(self, zf=None, yf=None):
        """Full-order output zf or measurement yf about the reference."""
        return shift_reference(zf, yf, self.z_ref, self.y_ref, -1.0)

    def zy_to_zfyf(self, z=None, y=None):
        return shift_reference(z, y, self.z_ref, self.y_ref, 1.0)

    def x_to_zfyf(self, x, zf=False, yf=False):
        """Full-order output (zf) or measurement (yf) of states x (..., n)."""
        if zf and self.H is not None:
            return x @ self.H.T + self.z_ref
        if yf and self.C is not None:
            return x @ self.C.T + self.y_ref
        raise RuntimeError("Need to set output or meas. model")

    def x_to_zy(self, x, z=False, y=False):
        """Reduced output (z) or measurement (y) of states x (..., n),
        about the reference."""
        if z and self.H is not None:
            return x @ self.H.T
        if y and self.C is not None:
            return x @ self.C.T
        raise RuntimeError("Need to set output or meas. model")

    # point selection -----------------------------------------------------
    def point_distances(self, x):
        """Weighted distances of state x (n,) to every dictionary point."""
        q, v = x2qv(x)
        return (self.dist_w_q * torch.linalg.vector_norm(self.q - q, dim=1)
                + self.dist_w_v * torch.linalg.vector_norm(self.v - v, dim=1))

    def calc_nearest_point(self, x):
        return torch.argmin(self.point_distances(x))

    def calc_weighting_factors(self, x):
        """Weights exp(-beta d_i / d_min) over the dictionary, normalized,
        for states x (..., n); a state at distance 0 from a point puts
        weight 1 on the first such point."""
        from soft_robot_control_tpu_torch.ops.tpwl_select import (
            point_distances_batch)

        lead = x.shape[:-1]
        dist = point_distances_batch(x.reshape(-1, x.shape[-1]), self.q,
                                     self.v, self.dist_w_q, self.dist_w_v)
        m_idx = torch.argmin(dist, dim=1, keepdim=True)
        m = dist.gather(1, m_idx)
        safe_m = torch.where(m == 0, torch.ones_like(m), m)
        w = torch.exp(-self.beta * dist / safe_m)
        w = w / w.sum(dim=1, keepdim=True)
        one_hot = torch.zeros_like(dist).scatter_(1, m_idx, 1.0)
        return torch.where(m == 0, one_hot, w).reshape(lead + dist.shape[1:])

    # jacobians ------------------------------------------------------------
    def get_jacobians(self, x, dt=None, u=None):
        """(A, B, d) at the states x (..., n): continuous if dt is None,
        else discrete. In 'nn' mode one launch of the select kernel fetches
        the rows for every state: from the pre-discretized tables when dt
        equals pre_discretized_dt, else from the continuous ones, whose rows
        are then discretized when dt is given. Computed in the model's
        dtype."""
        lead = x.shape[:-1]
        n, m = self.state_dim, self.input_dim
        xb = x.reshape(-1, n).to(self.q.dtype)
        if self.tpwl_method == "weighting":
            A, B, d = self._blend(self.calc_weighting_factors(xb), dt)
        elif self.tpwl_method == "nn":
            cached = (self.pre_discretized_dt is not None and dt is not None
                      and dt == self.pre_discretized_dt)
            tables = ((self.A_d, self.B_d, self.d_d) if cached
                      else (self.A_c, self.B_c, self.d_c))
            from soft_robot_control_tpu_torch.ops.tpwl_select import (
                tpwl_select)

            _, A, B, d = tpwl_select(xb, self.q, self.v, *tables,
                                     self.dist_w_q, self.dist_w_v)
            if dt is not None and not cached:
                A, B, d = self.discretize_dynamics(A, B, d, dt)
        else:
            raise RuntimeError("tpwl method should be nn or weighting")
        return (A.reshape(lead + (n, n)), B.reshape(lead + (n, m)),
                d.reshape(lead + (n,)))

    def _blend(self, w, dt=None):
        """(A, B, d) of the continuous dictionary blended by the weights w
        (B, P), discretized when dt is given."""
        A = torch.einsum("bp,pjk->bjk", w, self.A_c)
        B = torch.einsum("bp,pjk->bjk", w, self.B_c)
        d = w @ self.d_c
        if dt is not None:
            A, B, d = self.discretize_dynamics(A, B, d, dt)
        return A, B, d

    def discretize_dynamics(self, A_c, B_c, d_c, dt):
        return disc.discretize_affine(A_c, B_c, d_c, dt,
                                      method=self.discr_method)

    # discretization ------------------------------------------------------
    def pre_discretize(self, dt) -> "TPWLModel":
        """Discretize every dictionary point in one batched call; a
        dictionary already discrete at this dt is returned as-is."""
        if (self.A_d is not None and self.pre_discretized_dt is not None
                and abs(self.pre_discretized_dt - float(dt)) < 1e-12):
            return self
        if self.tpwl_method != "nn":
            raise RuntimeError("tpwl method should be nn to pre-discretize")
        A_d, B_d, d_d = disc.discretize_affine_batch(
            self.A_c, self.B_c, self.d_c, dt, method=self.discr_method)
        return self._replace(A_d=A_d, B_d=B_d, d_d=d_d,
                             pre_discretized_dt=float(dt))

    # simulation -------------------------------------------------------------
    @staticmethod
    def update_dynamics(x, u, A_d, B_d, d_d):
        return ((A_d @ x[..., None]) + (B_d @ u[..., None]))[..., 0] + d_d

    def update_state(self, x, u, dt):
        """Next states of x (..., n) under inputs u (..., m)."""
        A, B, d = self.get_jacobians(x, dt=dt)
        return self.update_dynamics(x.to(A.dtype), u.to(A.dtype), A, B, d)

    def rollout(self, x0, u, dt):
        """Roll one trajectory forward: x (N+1, n_x), z (N+1, n_z) or None
        without an output model; one select launch a step."""
        x = rollout(self, x0, u, dt)
        z = self.x_to_zfyf(x, zf=True) if self.H is not None else None
        return x, z

    def get_sim_params(self):
        """The model's settings, for experiment logs."""
        return {"beta_weighting": None if self.beta is None
                else float(self.beta),
                "discr_method": self.discr_method,
                "tpwl_method": self.tpwl_method,
                "dist_weights": {"q": float(self.dist_w_q),
                                 "v": float(self.dist_w_v)}}

    def get_characteristic_dx(self, dt):
        """max |x_{k+1} - x_k| over the dictionary points stepped with
        their own inputs."""
        x = qv2x(self.q, self.v)
        return (self.update_state(x, self.u, dt) - x).abs().amax(dim=0)

    def select(self, x, index_only: int = 0):
        """Nearest-point (idx, A_d, B_d, d_d) for states x (B, n_x), the
        rows for states index_only.. only, through the TPWL select kernel
        on a card."""
        from soft_robot_control_tpu_torch.ops.tpwl_select import tpwl_select

        return tpwl_select(x, self.q, self.v, self.A_d, self.B_d, self.d_d,
                           self.dist_w_q, self.dist_w_v, index_only)


def rollout(model: TPWLModel, x0, u, dt):
    """Roll the TPWL dynamics from x0 (n_x,) under u (N, n_u): the states
    x (N+1, n_x), the JAX function's result. In 'nn' mode each step takes
    the pre-discretized tables when dt equals pre_discretized_dt, else the
    continuous ones discretized at dt (`get_jacobians`), one launch of the
    select kernel a step."""
    x = as_tensor(x0, model.q.dtype, model.device)
    u = as_tensor(u, model.q.dtype, model.device)
    xs = [x]
    for k in range(u.shape[0]):
        x = model.update_state(x, u[k], dt)
        xs.append(x)
    return torch.stack(xs)


def shift_reference(z, y, z_ref, y_ref, sign):
    """z + sign z_ref where z and z_ref are given, else y + sign y_ref (z
    and y tensors, arrays or lists), in the reference's dtype on its
    device: the output maps' move to and from the reference."""
    if z is not None and z_ref is not None:
        return as_tensor(z, z_ref.dtype, z_ref.device) + sign * z_ref
    if y is not None and y_ref is not None:
        return as_tensor(y, y_ref.dtype, y_ref.device) + sign * y_ref
    raise RuntimeError("Need to set output or meas. model")


def _dense(M):
    """Accept scipy sparse or dense input."""
    if hasattr(M, "todense"):
        return np.asarray(M.todense())
    return M


def _apply(Mf, x, dtype):
    Mf = torch.as_tensor(Mf, device=x.device)
    return Mf.to(dtype) @ x.to(dtype)


def _batch_distances(model: TPWLModel, X):
    """(B, P) weighted point distances of the states X (B, n_x) by the
    squared-norm expansion |q|^2 - 2 q.q_i + |q_i|^2 (two matrix products),
    the JAX package's 'matmul' form. Near-ties may resolve differently from
    the direct differences of `point_distances`."""
    q, v = x2qv(X)

    def dist(a, pts):
        d2 = ((a * a).sum(dim=1)[:, None] - 2.0 * a @ pts.T
              + (pts * pts).sum(dim=1)[None])
        return torch.sqrt(torch.clamp(d2, min=0.0))

    return model.dist_w_q * dist(q, model.q) + model.dist_w_v * dist(
        v, model.v)


def rollout_batch(model: TPWLModel, x0, u, dt, select: str = "auto",
                  interpret: bool = False):
    """Batched rollout: x0 (B, n_x), u (B, N, n_u) -> (B, N+1, n_x).

    select, as in the JAX package:
    - 'exact': with the pre-discretized nn dictionary at this dt, the
      nearest point by direct differences through the TPWL select kernel
      (one launch a step); otherwise `get_jacobians(x, dt)` a step;
    - 'pallas': the select kernel (it replaces the Pallas select); needs
      the cache;
    - 'matmul': distances by the squared-norm expansion
      (`_batch_distances`, plain PyTorch), argmin, gather; needs the
      cache. Near-ties may resolve differently from 'exact';
    - 'weighting': exponential weights exp(-beta d_i / d_min) over the
      dictionary (direct differences), the continuous matrices blended and
      discretized a step; needs beta;
    - 'auto': 'weighting' for a weighting-mode model, else 'matmul' for
      B >= 32 with the cache, else 'exact'.
    `interpret` runs the Pallas kernel in interpret mode on a TPU; it has
    no meaning here and is ignored.
    """
    use_cache = (model.pre_discretized_dt is not None
                 and model.tpwl_method == "nn"
                 and float(dt) == model.pre_discretized_dt)
    if select == "auto":
        if model.tpwl_method == "weighting":
            select = "weighting"
        else:
            select = "matmul" if (use_cache and x0.shape[0] >= 32) else "exact"
    if select not in ("exact", "matmul", "pallas", "weighting"):
        raise ValueError(f"unknown select {select!r}")
    if select == "weighting" and model.beta is None:
        raise ValueError("weighting mode needs beta "
                         "(params['beta_weighting'])")
    if select in ("matmul", "pallas") and not use_cache:
        raise ValueError(f"select='{select}' needs the pre-discretized nn "
                         "cache at this dt")
    with span("tpwl.rollout"):
        X = x0.to(model.q.dtype)
        u = u.to(model.q.dtype)
        xs = [X]
        for k in range(u.shape[1]):
            if select == "weighting":
                A, B, d = model._blend(model.calc_weighting_factors(X), dt)
            elif select == "matmul":
                i = torch.argmin(_batch_distances(model, X), dim=1)
                A, B, d = model.A_d[i], model.B_d[i], model.d_d[i]
            elif use_cache:
                _, A, B, d = model.select(X)
            else:
                A, B, d = model.get_jacobians(X, dt=dt)
            X = TPWLModel.update_dynamics(X, u[:, k], A, B, d)
            xs.append(X)
        return torch.stack(xs, dim=1)


# ---------------------------------------------------------------------------
# Construction from reference-format artifacts


def from_tpwl_dict(data, params: Optional[dict] = None, Cf=None, Hf=None,
                   discr_method: str = DISCR_METHOD_DEFAULT,
                   device="cuda") -> TPWLModel:
    """Build a TPWLModel from a reference-format TPWL dictionary or pkl path
    (keys q, v, u, A_c, B_c, d_c, rom_info{type,U,q_ref,v_ref}, and A_d,
    B_d, d_d with dt when the builder discretized it)."""
    from soft_robot_control_tpu_torch.utils.io import load_data

    if not isinstance(data, dict):
        data = load_data(data)
    if data["rom_info"]["type"] != "POD":
        raise NotImplementedError("Unknown ROM type")
    rom = POD(data["rom_info"], device=device)
    params = params or {}
    dw = params.get("dist_weights") or {"q": 1.0, "v": 1.0}
    has_disc = ("A_d" in data and data["A_d"] is not None
                and len(np.shape(data["A_d"])) == 3
                and data.get("dt", -1) not in (-1, None))
    model = TPWLModel(
        q=np.asarray(data["q"]), v=np.asarray(data["v"]),
        u=np.atleast_2d(np.asarray(data["u"])),
        A_c=np.asarray(data["A_c"]), B_c=np.asarray(data["B_c"]),
        d_c=np.asarray(data["d_c"]), rom=rom,
        A_d=np.asarray(data["A_d"]) if has_disc else None,
        B_d=np.asarray(data["B_d"]) if has_disc else None,
        d_d=np.asarray(data["d_d"]) if has_disc else None,
        dist_w_q=dw["q"], dist_w_v=dw["v"],
        beta=params.get("beta_weighting"),
        discr_method=discr_method,
        tpwl_method=params.get("tpwl_method", TPWL_METHOD_DEFAULT),
        pre_discretized_dt=float(data["dt"]) if has_disc else None,
        device=device,
    )
    if Cf is not None:
        model = model.set_measurement_model(Cf)
    if Hf is not None:
        model = model.set_output_model(Hf)
    return model
