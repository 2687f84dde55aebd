"""Pass-through observer assuming perfect full-state measurement
(sofacontrol/tpwl/observer.py:3-30)."""

from __future__ import annotations

import torch


class FullStateObserver:
    def __init__(self, n_x, H=None):
        self.x = None
        self.z = None
        self.meas_dim = n_x
        self.state_dim = n_x
        self.H = H

    def get_meas_dim(self):
        return self.meas_dim

    def get_observer_params(self):
        return {"meas_dim": self.meas_dim, "state_dim": self.state_dim}

    def initialize(self, xf):
        pass

    def update(self, u, y, dt, x=None):
        """The state is the given x (a tensor); z = H x when H is set."""
        self.x = x
        if self.H is None:
            self.z = x
            return
        H = torch.as_tensor(self.H, device=x.device)
        dt = torch.promote_types(H.dtype, x.dtype)
        self.z = x.to(dt) @ H.to(dt).T
