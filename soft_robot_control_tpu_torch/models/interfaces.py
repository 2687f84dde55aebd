"""GuSTO model adapters: the uniform dynamics contract

    get_continuous_dynamics(x, u) -> (f, A, B)
    get_discrete_dynamics(x, u, dt) -> (Ad, Bd, dd)
    get_characteristic_vals() -> (x_char, f_char)
    rollout(x0, u, dt)

batched over the leading axes of x and u, so GuSTO linearizes a whole
trajectory (or a batch of them) in one call: on a TPWL model, one launch of
the select kernel. The SSM adapter waits for the SSM model.
"""

from __future__ import annotations

from soft_robot_control_tpu_torch.core.packing import qv2x


class TPWLGuSTO:
    """Adapter for TPWLModel."""

    nonlinear_observer = False

    def __init__(self, dyn_sys):
        self.dyn_sys = dyn_sys
        if dyn_sys.H is None:
            raise RuntimeError("dyn_sys must have output model specified")
        self.H = dyn_sys.H
        self.n_x = dyn_sys.state_dim
        self.n_u = dyn_sys.input_dim
        self.n_z = self.H.shape[0]

    @property
    def device(self):
        return self.dyn_sys.device

    @property
    def dtype(self):
        return self.dyn_sys.q.dtype

    def get_continuous_dynamics(self, x, u):
        A, B, d = self.dyn_sys.get_jacobians(x)
        x, u = x.to(A.dtype), u.to(A.dtype)
        f = (A @ x[..., None] + B @ u[..., None])[..., 0] + d
        return f, A, B

    def get_discrete_dynamics(self, x, u, dt):
        return self.dyn_sys.get_jacobians(x, dt=dt)

    def pre_discretize(self, dt):
        self.dyn_sys = self.dyn_sys.pre_discretize(dt)

    def get_characteristic_vals(self):
        """max |.| of the states and of the dynamics over the dictionary
        points, as numpy arrays."""
        x = qv2x(self.dyn_sys.q, self.dyn_sys.v)
        f = self.get_continuous_dynamics(x, self.dyn_sys.u)[0]
        return (x.abs().amax(dim=0).cpu().numpy(),
                f.abs().amax(dim=0).cpu().numpy())

    def rollout(self, x0, u, dt):
        return self.dyn_sys.rollout(x0, u, dt)
