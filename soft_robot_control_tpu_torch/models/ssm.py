"""Data-driven Spectral Submanifold (SSM) reduced dynamics.

Polynomial reduced dynamics xdot = R phi(x) + B_r u (continuous) or
x+ = Rd phi(x) + Bd_r u (discrete), the manifold chart C_map (reduced ->
observed) and parametrization W_map (observed -> reduced), their Jacobians,
fe/be/bil/zoh discretization, and the algebraic manifold observer
x = W_map(z - z_ref): the semantics of the JAX package's models/ssm.py.

Every method takes any leading batch axes, where the JAX package vmaps
one-point methods: one call linearizes a whole batch of trajectories. The
Jacobians of the polynomial maps are the analytic derivative of the
monomial basis (ops/monomials.py), exact at the origin. The model's
tensors lie on one device in one dtype.

Loads the MATLAB artifacts of SSMLearn unchanged (py_data.model.{w_coeff,
v_coeff, r_coeff, B, rd_coeff, Bd, Ts[, z_ref]}, py_data.params.{state_dim,
input_dim, output_dim, SSM_order, ROM_order}).
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.core import discretize as disc
from soft_robot_control_tpu_torch.ops.monomials import (eval_monomials,
                                                        monomial_exponents,
                                                        monomial_jacobian)
from soft_robot_control_tpu_torch.utils.device import as_tensor, resolve_device


def _mv(M, v):
    """M v over leading batch axes (M may be one matrix)."""
    return (M @ v[..., None])[..., 0]


class SSMModel:
    """SSM reduced dynamics on one device, in one dtype. Methods that
    change the model return a new one."""

    _children = ("w_coeff", "v_coeff", "r_coeff", "B_r", "rd_coeff", "Bd_r",
                 "z_ref")

    def __init__(self, w_coeff, v_coeff, r_coeff, B_r, rd_coeff, Bd_r, z_ref,
                 state_dim: int, input_dim: int, output_dim: int,
                 SSM_order: int, ROM_order: int, Ts: float = 0.0,
                 discrete: bool = False, discr_method: str = "fe",
                 dtype=torch.float64, device="cuda"):
        dev = resolve_device(device)
        t = lambda a: None if a is None else as_tensor(a, dtype, dev)
        self.w_coeff, self.v_coeff, self.r_coeff = (t(w_coeff), t(v_coeff),
                                                    t(r_coeff))
        self.B_r, self.rd_coeff, self.Bd_r = t(B_r), t(rd_coeff), t(Bd_r)
        self.z_ref = t(z_ref).reshape(-1)
        self.state_dim = int(state_dim)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.SSM_order = int(SSM_order)
        self.ROM_order = int(ROM_order)
        self.Ts = float(Ts)
        self.discrete = bool(discrete)
        self.discr_method = discr_method
        self._tables()

    def _tables(self):
        """The exponent tables as tensors beside the coefficients."""
        t = lambda e: torch.as_tensor(e, dtype=self.dtype, device=self.device)
        self._rom_exps = t(monomial_exponents(self.state_dim, self.ROM_order))
        self._ssm_exps = t(monomial_exponents(self.output_dim,
                                              self.SSM_order))

    @property
    def device(self):
        return self.w_coeff.device

    @property
    def dtype(self):
        return self.w_coeff.dtype

    def to(self, dtype=None, device=None) -> "SSMModel":
        """Copy with every tensor cast to `dtype` and/or moved to
        `device`."""
        obj = SSMModel.__new__(SSMModel)
        obj.__dict__.update(self.__dict__)
        for k in self._children:
            a = getattr(self, k)
            if a is not None:
                setattr(obj, k, a.to(device=device, dtype=dtype))
        obj._tables()
        return obj

    def _t(self, a):
        return as_tensor(a, self.dtype, self.device)

    # dims / flags ---------------------------------------------------------
    nonlinear_observer = True

    @property
    def H(self):
        """Zeros placeholder (n_z, n_x): the output map is the nonlinear
        chart."""
        return torch.zeros((self.output_dim, self.state_dim),
                           dtype=self.dtype, device=self.device)

    def get_state_dim(self):
        return self.state_dim

    def get_input_dim(self):
        return self.input_dim

    def get_output_dim(self):
        return self.output_dim

    # polynomial maps --------------------------------------------------------
    def reduced_dynamics(self, x, u):
        x, u = self._t(x), self._t(u)
        return (eval_monomials(x, self._rom_exps) @ self.r_coeff.T
                + u @ self.B_r.T)

    def reduced_dynamics_discrete(self, x, u):
        x, u = self._t(x), self._t(u)
        return (eval_monomials(x, self._rom_exps) @ self.rd_coeff.T
                + u @ self.Bd_r.T)

    def C_map(self, x):
        """Reduced -> observed (chart), x (..., n_x) -> (..., n_z)."""
        return eval_monomials(self._t(x), self._ssm_exps) @ self.w_coeff.T

    def W_map(self, z):
        """Observed -> reduced (parametrization)."""
        return eval_monomials(self._t(z), self._ssm_exps) @ self.v_coeff.T

    reduced_to_observed = C_map
    observed_to_reduced = W_map

    # shifted-output helpers -------------------------------------------------
    def zfyf_to_zy(self, zf):
        return self._t(zf) - self.z_ref

    def zy_to_zfyf(self, z):
        return self._t(z) + self.z_ref

    def x_to_zfyf(self, x, zf=True):
        return self.C_map(x) + self.z_ref

    def x_to_zy(self, x):
        return self.C_map(x)

    def compute_RO_state(self, z):
        """Manifold projection of an (unshifted) observation."""
        return self.W_map(self._t(z) - self.z_ref)

    # jacobians ----------------------------------------------------------------
    def _linearize(self, coeff, Bm, x, u):
        """(A, B, d) of x -> coeff phi(x) + Bm u at (x, u): A the analytic
        Jacobian, d = f - A x - B u."""
        x, u = self._t(x), self._t(u)
        A = coeff @ monomial_jacobian(x, self._rom_exps)
        B = Bm.expand(x.shape[:-1] + Bm.shape)
        f = eval_monomials(x, self._rom_exps) @ coeff.T + u @ Bm.T
        return A, B, f - _mv(A, x) - u @ Bm.T

    def get_continuous_jacobians(self, x, u):
        return self._linearize(self.r_coeff, self.B_r, x, u)

    def get_discrete_jacobians(self, x, u):
        return self._linearize(self.rd_coeff, self.Bd_r, x, u)

    def get_jacobians(self, x, u, dt=None):
        """Discrete (A, B, d) at (x, u): the native discrete model if the
        model is discrete, else the continuous Jacobians, discretized when
        dt is given."""
        if self.discrete:
            return self.get_discrete_jacobians(x, u)
        A, B, d = self.get_continuous_jacobians(x, u)
        if dt is not None:
            A, B, d = self.discretize_dynamics(A, B, d, dt)
        return A, B, d

    def get_observer_jacobians(self, x):
        """(H, c) of the chart at x: z ~ H x + c, H (..., n_z, n_x)."""
        x = self._t(x)
        H = self.w_coeff @ monomial_jacobian(x, self._ssm_exps)
        return H, self.C_map(x) - _mv(H, x)

    def discretize_dynamics(self, A_c, B_c, d_c, dt):
        return disc.discretize_affine(A_c, B_c, d_c, dt,
                                      method=self.discr_method)

    # simulation -----------------------------------------------------------
    @staticmethod
    def update_dynamics(x, u, A_d, B_d, d_d):
        return _mv(A_d, x) + _mv(B_d, u) + d_d

    def update_state(self, x, u, dt):
        """One step of the dynamics linearized at (x, u)."""
        A, B, d = self.get_jacobians(x, u, dt)
        return self.update_dynamics(self._t(x), self._t(u), A, B, d)

    def update_observer_state(self, x):
        H, c = self.get_observer_jacobians(x)
        return _mv(H, self._t(x)) + c

    def rollout(self, x0, u, dt):
        """Roll x0 (..., n_x) forward under u (..., T, n_u): returns
        (x (..., T+1, n_x), z (..., T+1, n_z)), z the unshifted output."""
        x, u = self._t(x0), self._t(u)
        xs = [x]
        for k in range(u.shape[-2]):
            x = self.update_state(x, u[..., k, :], dt)
            xs.append(x)
        x = torch.stack(xs, dim=-2)
        return x, self.x_to_zfyf(x)

    def get_ref_point(self):
        return self.z_ref

    def get_sim_params(self):
        return {"discr_method": self.discr_method, "discrete": self.discrete}


# the reference's class name
SSMDynamics = SSMModel


def from_mat(data, eq_point, discrete=False, discr_method="fe",
             dtype=torch.float64, device="cuda") -> SSMModel:
    """An SSMModel from SSMLearn .mat content: a path to the file or the
    already-indexed py_data[0, 0] struct. With eq_point None, an artifact
    that carries its equilibrium (model.z_ref) supplies it."""
    if isinstance(data, str):
        from scipy.io import loadmat

        data = loadmat(data)["py_data"][0, 0]
    model = data["model"]
    params = data["params"]

    def p(name):
        return int(params[name][0, 0][0, 0])

    def m(name):
        return model[name][0, 0]

    if eq_point is None and "z_ref" in getattr(model.dtype, "names", ()):
        eq_point = model["z_ref"][0, 0]
    return SSMModel(
        w_coeff=m("w_coeff"), v_coeff=m("v_coeff"), r_coeff=m("r_coeff"),
        B_r=m("B"), rd_coeff=m("rd_coeff"), Bd_r=m("Bd"),
        z_ref=np.asarray(eq_point, dtype=float).reshape(-1),
        state_dim=p("state_dim"), input_dim=p("input_dim"),
        output_dim=p("output_dim"), SSM_order=p("SSM_order"),
        ROM_order=p("ROM_order"), Ts=float(m("Ts")[0, 0]),
        discrete=discrete, discr_method=discr_method, dtype=dtype,
        device=device)
