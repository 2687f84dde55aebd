"""Koopman lifted-linear models with delay embedding.

- KoopmanScaling: affine up/down scaling of measurements and inputs;
- KoopmanData: the online delay buffer zeta = [y; y_delays; u_delays];
- KoopmanModel: lifted LTI dynamics x+ = A_d x + B_d u, y = C x on
  polynomial observables of zeta, from the MATLAB-trained .mat artifacts
  (the soft-robot-koopman layout) or from plain arrays;
- the lifting: a grlex exponent table with the constant monomial at the
  end, evaluated as power products (ops/monomials.py:eval_monomials);
- train_edmd: least-squares EDMD on lifted snapshots.

The delay buffer and the scaling work on numpy arrays on the host, as the
controller feeds them; the lifted model's arrays and the lifting live on
`device` in `dtype`.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import product

import numpy as np
import torch

from soft_robot_control_tpu_torch.ops.monomials import eval_monomials
from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                       resolve_device,
                                                       to_numpy)


@lru_cache(maxsize=None)
def koopman_exponents(dim: int, order: int, dmd: bool = False):
    """grlex exponent table with the reference's handling of the constant:
    sorted by (total degree, ascending lex on the reversed exponents); the
    constant monomial is dropped for DMD and moved to the END otherwise.
    Returns an (n_mono, dim) int32 array."""
    exps = [e for e in product(range(order + 1), repeat=dim)
            if 0 < sum(e) <= order]
    exps.sort(key=lambda e: (sum(e), tuple(reversed(e))))
    if not dmd:
        exps.append((0,) * dim)
    return np.asarray(exps, dtype=np.int32)


class KoopmanScaling:
    """Affine scaling; `scale` indexes as the .mat struct does
    (scale["y_offset"][0, 0])."""

    def __init__(self, scale):
        self.y_offset = np.asarray(scale["y_offset"][0, 0])
        self.y_factor = np.asarray(scale["y_factor"][0, 0])
        self.u_offset = np.asarray(scale["u_offset"][0, 0])
        self.u_factor = np.asarray(scale["u_factor"][0, 0])

    def scale_up(self, u=None, y=None):
        if y is not None:
            return y * self.y_factor + self.y_offset
        return u * self.u_factor + self.u_offset

    def scale_down(self, u=None, y=None):
        if y is not None:
            return (y - self.y_offset) / self.y_factor
        return (u - self.u_offset) / self.u_factor


class KoopmanData:
    """Online delay-embedding buffer of scaled measurements and inputs."""

    def __init__(self, scale, delay):
        self.delay = delay
        self.scaling = KoopmanScaling(scale)
        self.y_norm = None
        self.u_norm = None

    def add_measurement(self, y, u):
        y = np.atleast_2d(self.scaling.scale_down(y=np.asarray(y)))
        u = np.atleast_2d(self.scaling.scale_down(u=np.asarray(u)))
        if self.y_norm is None:
            self.y_norm, self.u_norm = y, u
        else:
            self.y_norm = np.append(self.y_norm, y, axis=0)
            self.u_norm = np.append(self.u_norm, u, axis=0)

    def get_zeta(self, step=-1):
        """[y_step, y_{step-1}, ..., u_{step-1}, ...], or None before
        delay+1 measurements."""
        if len(self.y_norm) < self.delay + 1:
            return None
        ny, nu = self.y_norm.shape[1], self.u_norm.shape[1]
        ydel = np.zeros(self.delay * ny)
        udel = np.zeros(self.delay * nu)
        for j in range(self.delay):
            ydel[ny * j:ny * (j + 1)] = self.y_norm[step - (j + 1), :]
            udel[nu * j:nu * (j + 1)] = self.u_norm[step - (j + 1), :]
        return np.hstack([self.y_norm[step], ydel, udel])


class KoopmanOfflineData(KoopmanData):
    """Bulk zeta computation over a recorded run."""

    def __init__(self, scale, delay):
        super().__init__(scale, delay)
        self.y = None
        self.u = None
        self.t = None
        self.zeta = None

    def load_offline_data(self, file):
        from soft_robot_control_tpu_torch.utils.io import load_data

        data = load_data(file)
        self.y = np.asarray(data["z"])
        self.t = np.asarray(data["t"])
        self.u = np.asarray(data["u"])
        self.y_norm = self.scaling.scale_down(y=self.y)
        self.u_norm = self.scaling.scale_down(u=self.u)

    def add_zeta_offline(self):
        self.zeta = np.asarray([self.get_zeta(step=i) for i in
                                range(self.delay, self.y_norm.shape[0])])


class ScaleRows(dict):
    """A dict of plain arrays indexed as the .mat struct:
    scale['y_offset'][0, 0] is the row."""

    def __getitem__(self, k):
        return np.asarray(dict.__getitem__(self, k)).reshape(1, 1, -1)


class KoopmanModel:
    """Lifted linear model from the MATLAB artifact: `model_in` and
    `params_in` are the 'model' and 'params' structs of
    scipy.io.loadmat(path)['py_data'][0, 0]. A_d, B_d, C, H, V, W and the
    exponent table are tensors in `dtype` on `device`."""

    def __init__(self, model_in, params_in, DMD=False, dtype=torch.float64,
                 device="cuda"):
        def scalar(name):
            v = params_in[name]
            while isinstance(v, np.ndarray):
                v = v.ravel()[0]
            return v

        A_d = np.asarray(model_in["A"][0, 0])
        names = model_in.dtype.names if hasattr(model_in, "dtype") else ()
        eye = np.eye(A_d.shape[0])
        self._setup(A_d, np.asarray(model_in["B"][0, 0]),
                    np.asarray(model_in["C"][0, 0]),
                    np.asarray(model_in["V"][0, 0]) if "V" in names else eye,
                    np.asarray(model_in["W"][0, 0]) if "W" in names else eye,
                    n=scalar("n"), m=scalar("m"), nzeta=scalar("nzeta"),
                    delays=scalar("delays"), obs_degree=scalar("obs_degree"),
                    obs_type=str(params_in["obs_type"][0, 0][0, 0][0]),
                    Ts=scalar("Ts"), scale=params_in["scale"][0, 0], dmd=DMD,
                    dtype=dtype, device=device)
        self.M = model_in["M"][0, 0]
        self.K = model_in["K"][0, 0]
        if int(scalar("N")) != self.N:
            raise ValueError(f"params N={scalar('N')} but A is "
                             f"{self.N}x{self.N}")

    def _setup(self, A_d, B_d, C, V, W, n, m, nzeta, delays, obs_degree,
               obs_type, Ts, scale, dmd, dtype, device):
        self.device = resolve_device(device)
        self.dtype = dtype
        t = lambda a: as_tensor(np.asarray(a, np.float64), dtype, self.device)
        self.A_d, self.B_d, self.C = t(A_d), t(B_d), t(C)
        self.H = self.C.clone()
        self.V, self.W = t(V), t(W)
        self.M = self.K = None
        self.n, self.m = int(n), int(m)
        self.N = self.A_d.shape[0]
        self.state_dim = int(nzeta)
        self.delays = int(delays)
        self.obs_degree = int(obs_degree)
        self.obs_type = obs_type
        self.Ts = float(Ts)
        self.scale = scale
        self.DMD = dmd
        self.assert_dimensions()
        if self.obs_type != "poly":
            raise NotImplementedError(self.obs_type)
        self._exps = t(koopman_exponents(self.state_dim, self.obs_degree,
                                         dmd=dmd))

    def assert_dimensions(self):
        if (tuple(self.A_d.shape) != (self.N, self.N)
                or tuple(self.B_d.shape) != (self.N, self.m)
                or tuple(self.C.shape) != (self.n, self.N)):
            raise ValueError(
                f"A {tuple(self.A_d.shape)}, B {tuple(self.B_d.shape)}, C "
                f"{tuple(self.C.shape)} do not fit N={self.N}, m={self.m}, "
                f"n={self.n}")

    def lift_data(self, *zeta):
        """phi(zeta): the lifted observable vector (n_lift,)."""
        z = as_tensor(np.asarray(zeta, float), self.dtype,
                      self.device).reshape(-1)
        return eval_monomials(z, self._exps)

    def lift_batch(self, Z):
        """(T, nzeta) -> (T, n_lift)."""
        return eval_monomials(as_tensor(Z, self.dtype, self.device),
                              self._exps)

    def get_state_dim(self):
        return self.N

    def get_input_dim(self):
        return self.m


def koopman_model_from_arrays(A_d, B_d, C, n, m, nzeta, delays, obs_degree,
                              Ts, scale_dict, dmd=False, dtype=torch.float64,
                              device="cuda") -> KoopmanModel:
    """A KoopmanModel from plain arrays (the EDMD path, no MATLAB
    artifact). scale_dict: {y_offset, y_factor, u_offset, u_factor} plain
    arrays."""
    obj = KoopmanModel.__new__(KoopmanModel)
    eye = np.eye(np.asarray(to_numpy(A_d)).shape[0])
    obj._setup(to_numpy(A_d), to_numpy(B_d), to_numpy(C), eye, eye, n=n,
               m=m, nzeta=nzeta, delays=delays, obs_degree=obs_degree,
               obs_type="poly", Ts=Ts, scale=ScaleRows(scale_dict), dmd=dmd,
               dtype=dtype, device=device)
    return obj


class KoopmanObserver:
    """Trivial observer: the measurement is the output."""

    def __init__(self):
        self.z = None
        self.x = None

    def update(self, u, y, dt, x=None):
        self.z = y


def train_edmd(zeta, u, degree: int, dmd: bool = False, reg: float = 0.0,
               device="cuda"):
    """EDMD: fit x+ = A phi(zeta_k) + B u_k by (ridge) least squares, with
    x = phi(zeta). zeta: (T, nzeta) scaled delay-embedded measurements; u:
    (T, m) scaled inputs. The lifting and the normal equations run in
    float64 on `device`. Returns numpy (A, B, C), C recovering zeta from
    the lifted state (the first nzeta observables)."""
    dev = resolve_device(device)
    t = lambda a: as_tensor(np.asarray(a, np.float64), torch.float64, dev)
    exps = koopman_exponents(zeta.shape[1], degree, dmd=dmd)
    Phi = eval_monomials(t(zeta), exps)
    X, Xp = Phi[:-1], Phi[1:]
    G = torch.cat([X, t(u)[:-1]], dim=1)
    eye = torch.eye(G.shape[1], dtype=torch.float64, device=dev)
    A_aug = to_numpy(torch.linalg.solve(G.T @ G + reg * eye, G.T @ Xp).T)
    n_lift = Phi.shape[1]
    C = np.zeros((zeta.shape[1], n_lift))
    C[:, :zeta.shape[1]] = np.eye(zeta.shape[1])
    return A_aug[:, :n_lift], A_aug[:, n_lift:], C
