"""Single-linearization (ROMPC-style) linear reduced-order model: one
linearization point, discretized once, with the TPWL model's output and
measurement API."""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.core import discretize as disc
from soft_robot_control_tpu_torch.rom.pod import POD


class LinearROM:
    """(A_d, B_d, d_d) of one point, on `device`; the dictionary's discrete
    point when it carries one at this dt, else the ZOH of its continuous
    point."""

    def __init__(self, data, dt, Cf=None, Hf=None, device="cuda"):
        from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                               resolve_device)

        if not isinstance(data, dict):
            from soft_robot_control_tpu_torch.utils.io import load_data

            data = load_data(data)
        dev = resolve_device(device)
        t = lambda a: as_tensor(a, device=dev)
        if "A_d" in data and data.get("dt") is not None and \
                abs(float(data["dt"]) - float(dt)) < 1e-12:
            # the dictionary's projected implicit step map: at tet scale
            # the continuous Galerkin point is stiff and its ZOH unstable
            self.A_d = t(data["A_d"])
            self.B_d = t(data["B_d"])
            self.d_d = t(np.asarray(data["d_d"]).reshape(-1))
        else:
            self.A_d, self.B_d, self.d_d = disc.zoh_affine(
                t(data["A_c"]), t(data["B_c"]),
                t(np.asarray(data["d_c"]).reshape(-1)), dt)
        if data["rom_info"]["type"] != "POD":
            raise NotImplementedError("Unknown ROM type")
        self.rom = POD(data["rom_info"], device=dev)
        self.C = self.y_ref = self.H = self.z_ref = None
        if Cf is not None:
            Cf = _dense(Cf)
            self.C = self.rom.project_output_matrix(Cf)
            self.y_ref = _apply(Cf, self.rom.x_ref, self.C.dtype)
        if Hf is not None:
            Hf = _dense(Hf)
            self.H = self.rom.project_output_matrix(Hf)
            self.z_ref = _apply(Hf, self.rom.x_ref, self.H.dtype)

    @property
    def device(self):
        return self.A_d.device

    # dims ----------------------------------------------------------------
    @property
    def state_dim(self):
        return self.A_d.shape[0]

    @property
    def input_dim(self):
        return self.B_d.shape[1]

    def get_output_dim(self):
        return None if self.H is None else self.H.shape[0]

    def get_meas_dim(self):
        return None if self.C is None else self.C.shape[0]

    nonlinear_observer = False

    # dynamics -------------------------------------------------------------
    def get_jacobians(self, x, dt=None, u=None):
        return self.A_d, self.B_d, self.d_d

    def update_state(self, x, u):
        """Next states of x (..., n) under inputs u (..., m), in the
        promoted dtype of x and the model."""
        dt = torch.promote_types(x.dtype, self.A_d.dtype)
        return (x.to(dt) @ self.A_d.T.to(dt) + u.to(dt) @ self.B_d.T.to(dt)
                + self.d_d.to(dt))

    def rollout(self, x0, u, dt=None):
        """States (N+1, n) and outputs (N+1, n_z) (None without an output
        model) of one input sequence u (N, m), in the promoted dtype of x0
        and the model."""
        x = torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0)
                            else x0, device=self.device)
        x = x.to(torch.promote_types(x.dtype, self.A_d.dtype))
        u = torch.as_tensor(np.asarray(u) if not torch.is_tensor(u) else u,
                            dtype=x.dtype, device=self.device)
        xs = [x]
        for k in range(u.shape[0]):
            x = self.update_state(x, u[k])
            xs.append(x)
        x = torch.stack(xs)
        z = self.x_to_zfyf(x, zf=True) if self.H is not None else None
        return x, z

    # output maps (the TPWL model's contract) --------------------------------
    def x_to_zfyf(self, x, zf=False, yf=False):
        if zf and self.H is not None:
            return x.to(self.H.dtype) @ self.H.T + self.z_ref
        if yf and self.C is not None:
            return x.to(self.C.dtype) @ self.C.T + self.y_ref
        raise RuntimeError("Need to set output or meas. model")


def _dense(M):
    if hasattr(M, "todense"):
        return np.asarray(M.todense())
    return np.asarray(M)


def _apply(Mf, x, dtype):
    return torch.as_tensor(Mf, device=x.device).to(dtype) @ x.to(dtype)


def tpwl_to_linear_rom(tpwl_path_or_dict, save_path=None):
    """The first TPWL linearization point as a LinearROM data dict, with
    the dictionary's discrete point when it has one (the ZOH of the stiff
    continuous point is unstable at tet scale)."""
    from soft_robot_control_tpu_torch.utils.io import load_data, save_data

    data = tpwl_path_or_dict
    if not isinstance(data, dict):
        data = load_data(data)
    out = {"A_c": np.asarray(data["A_c"][0]), "B_c": np.asarray(data["B_c"][0]),
           "d_c": np.asarray(data["d_c"][0]), "rom_info": data["rom_info"]}
    if "A_d" in data:
        out.update(A_d=np.asarray(data["A_d"][0]),
                   B_d=np.asarray(data["B_d"][0]),
                   d_d=np.asarray(data["d_d"][0]), dt=float(data["dt"]))
    if save_path is not None:
        save_data(save_path, out)
    return out
