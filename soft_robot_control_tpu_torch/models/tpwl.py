"""Trajectory-PieceWise-Linear (TPWL) reduced dynamics.

A dictionary of P linearization points {q, v, u, A_c, B_c, d_c} stacked
into tensors, nearest-point selection by weighted distance,
pre-discretization of the whole dictionary in one batched call, and the
ROM-projected output and measurement maps C = Cf V, H = Hf V. The
exponential-weighting mode is not ported yet.

`rollout_batch` selects through the TPWL select kernel
(ops/tpwl_select.py) at every step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.core import discretize as disc
from soft_robot_control_tpu_torch.core.packing import x2qv
from soft_robot_control_tpu_torch.rom.pod import POD

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
        from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                               resolve_device)

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

    # point selection -----------------------------------------------------
    def point_distances(self, x):
        """Weighted distances of state x (n,) to every dictionary point."""
        q, v = x2qv(x)
        return (self.dist_w_q * torch.linalg.vector_norm(self.q - q, dim=1)
                + self.dist_w_v * torch.linalg.vector_norm(self.v - v, dim=1))

    def calc_nearest_point(self, x):
        return torch.argmin(self.point_distances(x))

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

    def select(self, x, index_only: int = 0):
        """Nearest-point (idx, A_d, B_d, d_d) for states x (B, n_x), the
        rows for states index_only.. only, through the TPWL select kernel
        on a card."""
        from soft_robot_control_tpu_torch.ops.tpwl_select import tpwl_select

        return tpwl_select(x, self.q, self.v, self.A_d, self.B_d, self.d_d,
                           self.dist_w_q, self.dist_w_v, index_only)


def _dense(M):
    """Accept scipy sparse or dense input."""
    if hasattr(M, "todense"):
        return np.asarray(M.todense())
    return M


def _apply(Mf, x, dtype):
    Mf = torch.as_tensor(Mf, device=x.device)
    return Mf.to(dtype) @ x.to(dtype)


def rollout_batch(model: TPWLModel, x0, u, dt):
    """Batched rollout on the pre-discretized dictionary.

    x0: (B, n_x); u: (B, N, n_u). Returns (B, N+1, n_x). Every step selects
    through the TPWL select kernel (plain version on the CPU)."""
    if (model.pre_discretized_dt is None or model.tpwl_method != "nn"
            or float(dt) != model.pre_discretized_dt):
        raise ValueError("rollout_batch needs the pre-discretized nn "
                         "dictionary at this dt (call pre_discretize)")
    xs = [x0]
    x = x0
    for k in range(u.shape[1]):
        _, A, B, d = model.select(x)
        x = (A @ x[..., None] + B @ u[:, k, :, None])[..., 0] + d
        xs.append(x)
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
