"""SSM manifold observer: algebraic projection of the measured output
through the parametrization map, x = W_map(z - z_ref)."""

from __future__ import annotations

from soft_robot_control_tpu_torch.core.packing import vq2qv
from soft_robot_control_tpu_torch.utils.device import as_tensor


class SSMObserver:
    def __init__(self, dyn_sys):
        self.dyn_sys = dyn_sys
        self.x = None
        self.z = None

    def initialize(self, xf=None):
        pass

    def update(self, u, y, dt, x=None):
        """y is the raw measurement (..., n) in [v; q] packing; the SSM
        convention is [q; v]."""
        m = self.dyn_sys
        self.z = vq2qv(as_tensor(y, m.dtype, m.device))
        self.x = m.W_map(m.zfyf_to_zy(self.z))
