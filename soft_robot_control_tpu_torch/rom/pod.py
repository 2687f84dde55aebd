"""POD reduced basis: affine projection x_r = U^T (x_f - x_ref) on the two
halves of the packed state x = [v; q] (the block basis kron(I_2, U) is
never materialized), and output-matrix projection H = Hf V."""

from __future__ import annotations

import torch

from soft_robot_control_tpu_torch.core.packing import qv2x


class POD:
    """POD basis. U: (n_f, r); q_ref, v_ref: (n_f,), all on one device."""

    def __init__(self, info: dict, device="cuda", dtype=None):
        from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                               resolve_device)

        dev = resolve_device(device)
        as_t = lambda a: as_tensor(a, dtype, dev)
        self.U = as_t(info["U"])
        self.q_ref = as_t(info["q_ref"])
        self.v_ref = as_t(info["v_ref"])

    @property
    def x_ref(self):
        return qv2x(self.q_ref, self.v_ref)

    @property
    def rom_dim(self) -> int:
        return self.U.shape[1]

    @property
    def full_dim(self) -> int:
        return self.U.shape[0]

    def project_x(self, xf):
        """Full -> reduced state, (..., 2 n_f) -> (..., 2 r)."""
        n = self.full_dim
        xf = torch.as_tensor(xf, device=self.U.device)
        dt = torch.promote_types(xf.dtype, self.U.dtype)
        U = self.U.to(dt)
        v = (xf[..., :n].to(dt) - self.v_ref.to(dt)) @ U
        q = (xf[..., n:].to(dt) - self.q_ref.to(dt)) @ U
        return qv2x(q, v)

    def project_output_matrix(self, Hf):
        """H = Hf V for a full-order output matrix Hf (n_z, 2 n_f), in the
        promoted dtype of Hf and U."""
        n = self.full_dim
        Hf = torch.as_tensor(Hf, device=self.U.device)
        dt = torch.promote_types(Hf.dtype, self.U.dtype)
        U = self.U.to(dt)
        return torch.cat((Hf[:, :n].to(dt) @ U, Hf[:, n:].to(dt) @ U), dim=1)
