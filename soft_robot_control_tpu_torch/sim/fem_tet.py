"""Tetrahedral FEM plant at reference mesh scale, the SOFA replacement (port
of the JAX package's sim/fem_tet.py).

The reference simulates the robots with SOFA's C++ TetrahedronFEMForceField
(method='large') + implicit Euler + Rayleigh damping over the shipped meshes
(robots/environments.py:139-238: Diamond diamond.vtu 1628 nodes / 9768-dim
state; :39-137: Trunk trunk.vtk 709 nodes / 4254-dim), actuated by cables
barycentrically mapped into the mesh, with the base fixed by a BoxROI.

The same method as the JAX package, in PyTorch on one device:

- Corotational elasticity: per-element rotations R_e from the deformation
  gradient by 10 Higham polar iterations, each a batched 3x3 inverse in
  closed form (cofactors over the determinant: no pivoting, no singularity
  check, so no host sync on the card); f_e = -R_e K_e (R_e^T x_e - x_e^rest)
  with the rest element stiffnesses K_e (E, 12, 12). Element sweeps are
  batched products; the scatter to the nodes is an out-of-place
  `index_add` (atomic on the card, so its order of summation is not fixed).
- The linearly implicit Euler step (M + dt D + dt^2 K_t) dv = dt (f - dt K_t
  v) solved matrix-free by PCG, preconditioned by the rest step matrix's
  inverse S0^-1 = S_q diag(1/S_lam) S_q^T applied in rotated node frames:
  two dense products a preconditioner call. The JAX `while_loop` becomes a
  host loop: each state of a batch stops at its own iteration (later
  iterations leave it as it is, selected with `torch.where`), and the host
  reads one flag, "any state still running", every CHECK_EVERY
  iterations. `solve_st_multi` keeps the JAX rule that all its columns
  iterate until the slowest converges.
- Matrix-free reduced Jacobians: `reduced_affine_dynamics` projects the
  tangent through jvp's of the element force sweep (`torch.func`),
  `reduced_discrete_dynamics` the implicit step through one multi-column
  PCG solve.

Units follow the SOFA scenes: mm, kg, s => force in mN, stress in kPa.
Mesh IO and the builders' assembly are numpy on the host, as in the JAX
package; the plant's tensors lie on one device in one dtype.
"""

from __future__ import annotations

import copy
import os
import re
import warnings

import numpy as np
import torch

from soft_robot_control_tpu_torch.core.packing import qv2x, x2qv
from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                       resolve_device,
                                                       to_numpy)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the reference checkout beside the repository (the JAX package's default);
# no test reads it
REFERENCE_ROOT = os.path.join(os.path.dirname(_REPO), "reference")
REFERENCE_MESH_DIR = os.path.join(REFERENCE_ROOT, "robots", "mesh")

# PCG iterations between two host reads of the "still running" flag
CHECK_EVERY = 4


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its scalar type)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype


def _numpy_dtype(dtype) -> np.dtype:
    """A numpy dtype from a torch or numpy dtype (or its scalar type)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


# ---------------------------------------------------------------------------
# Mesh IO


def load_vtu_ascii(path: str):
    """Parse an ASCII XML .vtu (UnstructuredGrid) into (points (n,3) f64,
    tets (E,4) i32). Covers the shipped diamond.vtu; keeps only tetrahedra
    (VTK cell type 10)."""
    txt = open(path).read()

    def _block(name_attr: str) -> np.ndarray:
        m = re.search(name_attr + r'"[^>]*>(.*?)</DataArray>', txt, re.S)
        if m is None:
            raise ValueError(f"missing DataArray {name_attr} in {path}")
        return np.array(m.group(1).split(), dtype=np.float64)

    pts = _block(r'NumberOfComponents="3" format="ascii').reshape(-1, 3)
    conn = _block(r'Name="connectivity" format="ascii').astype(np.int64)
    offs = _block(r'Name="offsets" format="ascii').astype(np.int64)
    types = _block(r'Name="types" format="ascii').astype(np.int64)
    cells, start = [], 0
    for off, typ in zip(offs, types):
        if typ == 10 and off - start == 4:
            cells.append(conn[start:off])
        start = off
    return pts, np.asarray(cells, dtype=np.int32)


def write_vtu_ascii(path: str, points: np.ndarray, tets: np.ndarray):
    """Write points (n,3) and tetrahedra (E,4) as the ASCII XML .vtu that
    `load_vtu_ascii` reads (a synthetic mesh in place of a shipped one)."""
    pts = " ".join(repr(float(a)) for a in np.asarray(points).reshape(-1))
    conn = " ".join(str(int(a)) for a in np.asarray(tets).reshape(-1))
    E = len(tets)
    offs = " ".join(str(4 * (e + 1)) for e in range(E))
    with open(path, "w") as f:
        f.write(
            '<?xml version="1.0"?>\n<VTKFile type="UnstructuredGrid">\n'
            f'<UnstructuredGrid><Piece NumberOfPoints="{len(points)}" '
            f'NumberOfCells="{E}">\n<Points><DataArray type="Float64" '
            f'NumberOfComponents="3" format="ascii">{pts}</DataArray>'
            '</Points>\n<Cells><DataArray type="Int64" Name="connectivity" '
            f'format="ascii">{conn}</DataArray>\n<DataArray type="Int64" '
            f'Name="offsets" format="ascii">{offs}</DataArray>\n'
            '<DataArray type="UInt8" Name="types" format="ascii">'
            + " ".join(["10"] * E) + "</DataArray></Cells>\n"
            "</Piece></UnstructuredGrid>\n</VTKFile>\n")


def load_vtk_legacy(path: str):
    """Parse a legacy-format .vtk (ASCII or BINARY big-endian, as written by
    Gmsh for the shipped trunk.vtk / finger.vtk) into (points, tets)."""
    raw = open(path, "rb").read()
    binary = b"\nBINARY" in raw[:200] or raw.splitlines()[2].strip() == b"BINARY"

    def _find_line(key: bytes, from_pos: int = 0):
        i = raw.index(key, from_pos)
        j = raw.index(b"\n", i)
        return raw[i:j].decode(), j + 1

    hdr, data_pos = _find_line(b"POINTS")
    n_pts = int(hdr.split()[1])
    pt_dtype = ">f8" if hdr.split()[2] == "double" else ">f4"
    if binary:
        nb = n_pts * 3 * np.dtype(pt_dtype).itemsize
        pts = np.frombuffer(raw[data_pos:data_pos + nb], dtype=pt_dtype)
        after = data_pos + nb
    else:
        cells_at = raw.index(b"CELLS", data_pos)
        pts = np.array(raw[data_pos:cells_at].split(), dtype=np.float64)
        after = cells_at
    pts = pts.astype(np.float64).reshape(n_pts, 3)

    hdr, data_pos = _find_line(b"CELLS", after)
    n_cells, sz = int(hdr.split()[1]), int(hdr.split()[2])
    if binary:
        nb = sz * 4
        cell_data = np.frombuffer(raw[data_pos:data_pos + nb], dtype=">i4")
        after = data_pos + nb
    else:
        types_at = raw.index(b"CELL_TYPES", data_pos)
        cell_data = np.array(raw[data_pos:types_at].split(), dtype=np.int64)
        after = types_at
    hdr, data_pos = _find_line(b"CELL_TYPES", after)
    if binary:
        types = np.frombuffer(raw[data_pos:data_pos + n_cells * 4], dtype=">i4")
    else:
        types = np.array(raw[data_pos:data_pos + 32 * n_cells].split()[:n_cells],
                         dtype=np.int64)
    cells, k = [], 0
    for c in range(n_cells):
        cnt = int(cell_data[k])
        if types[c] == 10 and cnt == 4:
            cells.append(cell_data[k + 1:k + 5])
        k += cnt + 1
    return pts, np.asarray(cells, dtype=np.int32)


def transform_mesh(points: np.ndarray, rotation_deg=(0.0, 0.0, 0.0),
                   translation=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Apply the SOFA loader's Euler-XYZ rotation (degrees) + translation
    (robots/environments.py:149-155: Diamond rotation=[90,0,0],
    translation=[0,0,35])."""
    rx, ry, rz = [np.deg2rad(a) for a in rotation_deg]

    def rot_x(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def rot_y(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R = rot_z(rz) @ rot_y(ry) @ rot_x(rx)
    return points @ R.T + np.asarray(translation)


# ---------------------------------------------------------------------------
# Element kernels (batched over all elements)


def _tet_precompute(points: np.ndarray, tets: np.ndarray):
    """Rest shape-matrix inverses Dm^-1 (E,3,3) and volumes (E,). Elements
    with non-positive volume are reoriented (vertex swap)."""
    tets = np.asarray(tets).copy()
    p = points[tets]  # (E,4,3)
    Dm = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]],
                  axis=-1)  # (E,3,3) columns = edges
    det = np.linalg.det(Dm)
    flip = det < 0
    if flip.any():  # reorient so volumes are positive
        tets[flip, 2], tets[flip, 3] = tets[flip, 3].copy(), tets[flip, 2].copy()
        p = points[tets]
        Dm = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]],
                      axis=-1)
        det = np.linalg.det(Dm)
    vol = det / 6.0
    keep = vol > 1e-12
    return tets[keep], np.linalg.inv(Dm[keep]), vol[keep]


def _cofactor_t(X):
    """Rows r1 x r2, r2 x r0, r0 x r1 of (..., 3, 3) matrices with rows
    r0, r1, r2: det(X) X^-T, and the determinant."""
    C = torch.linalg.cross(X.roll(-1, dims=-2), X.roll(-2, dims=-2), dim=-1)
    return C, (X[..., 0, :] * C[..., 0, :]).sum(-1)


def _polar_rotations(F, iters: int = 10):
    """Batched rotation factors of (..., 3, 3) deformation gradients by the
    Higham Newton iteration X <- (X + X^-T)/2, the inverse in closed form:
    elementwise work only, differentiable by `torch.func`."""
    X = F
    for _ in range(iters):
        C, det = _cofactor_t(X)
        X = 0.5 * (X + C / det[..., None, None])
    return X


def _edges(pos):
    """Edge matrices (..., E, 3, 3), columns p1 - p0, p2 - p0, p3 - p0, of
    vertex positions (..., E, 4, 3)."""
    return (pos[..., 1:, :] - pos[..., :1, :]).transpose(-1, -2)


def _linear_element_forces(pos_e, Bm, vol, mu, lam):
    """Linear-elasticity nodal forces for all elements (small-strain Cauchy
    stress of the displacement gradient). Used only to derive the rest
    element stiffnesses K_e = -d f/d x at the rest configuration; the
    runtime force path is the corotational `TetFEM.f_int`.

    pos_e: (E,4,3) vertex positions; Bm: (E,3,3) = Dm^-1; vol: (E,).
    Returns (E,4,3) forces: sigma = 2 mu eps + lam tr(eps) I with
    eps = sym(F) - I; force matrix on vertices 1..3 = -vol * sigma * Bm^T.
    """
    F = _edges(pos_e) @ Bm
    I3 = torch.eye(3, dtype=pos_e.dtype, device=pos_e.device)
    eps = 0.5 * (F + F.transpose(-1, -2)) - I3
    tre = eps.diagonal(dim1=-2, dim2=-1).sum(-1)
    sigma = 2.0 * mu * eps + lam * tre[:, None, None] * I3
    Hm = -vol[:, None, None] * (sigma @ Bm.transpose(-1, -2))
    f123 = Hm.transpose(1, 2)  # columns -> rows: (E, 3 verts, 3)
    f0 = -f123.sum(dim=1, keepdim=True)
    return torch.cat([f0, f123], dim=1)  # (E,4,3)


# ---------------------------------------------------------------------------
# Plant

# the JAX plant's pytree leaves, in its order (`TetFEM.tree_flatten`)
LEAVES = ("rest_pos", "tets", "Bm", "vol", "Ke", "m_node", "alpha", "beta",
          "free_mask", "H", "K0", "S_q", "S_lam", "g_full", "q_eq")
_SCALARS = ("m_node", "alpha", "beta")


def _pcg(op, prec, b, max_iters: int, tol: float, together=False):
    """PCG on A x = b for every lane of b (..., k) at once, with the JAX
    `while_loop`'s rule per lane: iterate while k < max_iters and ||r|| >
    tol ||b||. A stopped lane keeps its state (selected with torch.where,
    so a NaN in its temporaries never reaches it); the host reads "any lane
    running" every CHECK_EVERY iterations. Returns (x, iterations a lane).

    together: the rule of JAX's `solve_st_multi` instead, every lane
    iterating until the slowest one converges; the iterations are then one
    0-d count. The denominators are clamped at the dtype's `tiny`, as there:
    a converged lane's would underflow into 0/0 NaNs. A running lane's are
    positive and pass unchanged."""
    z = prec(b)
    nr0 = torch.linalg.vector_norm(b, dim=-1)
    tiny = torch.finfo(b.dtype).tiny
    x, r, p, rz = torch.zeros_like(b), b, z, (b * z).sum(-1)
    its = torch.zeros(() if together else b.shape[:-1], dtype=torch.int64,
                      device=b.device)
    for k in range(max_iters):
        run = torch.linalg.vector_norm(r, dim=-1) > tol * nr0
        if together:
            run = run.any()
        if k % CHECK_EVERY == 0 and not bool(run.any()):
            break
        Ap = op(p)
        a = (rz / torch.clamp_min((p * Ap).sum(-1), tiny))[..., None]
        r1 = r - a * Ap
        z = prec(r1)
        rz1 = (r1 * z).sum(-1)
        p1 = z + (rz1 / torch.clamp_min(rz, tiny))[..., None] * p
        sel = run[..., None]
        x = torch.where(sel, x + a * p, x)
        r = torch.where(sel, r1, r)
        p = torch.where(sel, p1, p)
        rz = torch.where(run, rz1, rz)
        its = its + run
    return x, its


class TetFEM:
    """Tet-mesh FEM plant with the FEMSurrogate duck-type interface
    (f/step/jacobians/x_rest/q_rest/n_nodes_dof/state_dim/input_dim,
    device/dtype), plus the matrix-free `reduced_affine_dynamics` and
    `reduced_discrete_dynamics` the TPWL pipeline uses at scale. Positions
    are absolute (scene frame), x = [v; q]. States and inputs may carry
    leading batch axes in `f`, `force`, `step` and the matvecs.

    The arguments are the JAX plant's leaves (arrays or tensors) and its
    static fields; the float leaves become tensors of `dtype` (by default
    rest_pos's) on `device`, the element indices int64 there, and m_node,
    alpha, beta Python floats rounded to `dtype`."""

    def __init__(self, rest_pos, tets, Bm, vol, Ke, m_node, alpha, beta,
                 free_mask, H, K0, S_q, S_lam, g_full, q_eq, dt,
                 cg_iters: int = 80, cg_tol: float = 1e-6, device="cuda",
                 dtype=None):
        dev = resolve_device(device)
        if dtype is None:
            dtype = (rest_pos.dtype if torch.is_tensor(rest_pos)
                     else np.asarray(rest_pos).dtype)
        dt_ = _torch_dtype(dtype)
        t = lambda a: as_tensor(a, dt_, dev)
        self.rest_pos = t(rest_pos)    # (3n,) mesh rest positions
        self.tets = as_tensor(tets, torch.int64, dev)  # (E,4)
        self.Bm = t(Bm)                # (E,3,3) rest Dm^-1
        self.vol = t(vol)              # (E,)
        self.Ke = t(Ke)                # (E,12,12) rest element stiffness
        rnd = _numpy_dtype(dt_).type
        self.m_node = float(rnd(float(m_node)))
        self.alpha = float(rnd(float(alpha)))
        self.beta = float(rnd(float(beta)))
        self.free_mask = t(free_mask)  # (3n,) 1.0 free / 0.0 fixed
        self.H = t(H)                  # (3n, m)
        self.K0 = t(K0)                # (3n,3n) bc'd rest tangent
        self.S_q = t(S_q)              # (3n,3n) eigenvectors of S0
        self.S_lam = t(S_lam)          # (3n,) eigenvalues of S0
        self.g_full = t(g_full)        # (3n,) gravity accel per dof
        self.q_eq = t(q_eq)            # (3n,) equilibrium positions
        self.dt = float(dt)            # step size the factor is for
        self.cg_iters = int(cg_iters)  # PCG iteration cap per step
        self.cg_tol = float(cg_tol)    # PCG relative tolerance

    # ------------------------------------------------------------------
    @property
    def device(self):
        return self.rest_pos.device

    @property
    def dtype(self):
        return self.rest_pos.dtype

    @property
    def n_nodes(self) -> int:
        return self.rest_pos.shape[0] // 3

    @property
    def n_nodes_dof(self) -> int:
        return self.rest_pos.shape[0]

    @property
    def state_dim(self) -> int:
        return 2 * self.rest_pos.shape[0]

    @property
    def input_dim(self) -> int:
        return self.H.shape[1]

    @property
    def q_rest(self):
        """Equilibrium positions, what the reference saves as rest.pkl
        'after gravity effect' (robots/environments.py:160-168)."""
        return self.q_eq

    def x_rest(self):
        return qv2x(self.q_eq, torch.zeros_like(self.q_eq))

    def _t(self, a):
        return as_tensor(a, self.dtype, self.device)

    # element-frame machinery ---------------------------------------------
    def rotations(self, q):
        """Per-element rotations (..., E, 3, 3) from the deformation
        gradient."""
        return _polar_rotations(_edges(self._gather(q)) @ self.Bm)

    def node_rotations(self, R):
        """Per-node rotations (..., n, 3, 3): polar of the volume-weighted
        average of adjacent element rotations (identity fallback for
        degenerate averages). Used to apply the rest preconditioner in
        rotated frames."""
        lead = R.shape[:-3]
        n, idx = self.n_nodes, self.tets.reshape(-1)
        vals = (self.vol[:, None, None] * R).reshape(lead + (-1, 1, 9))
        vals = vals.expand(lead + (vals.shape[-3], 4, 9))
        acc = R.new_zeros(lead + (n, 9)).index_add(
            -2, idx, vals.reshape(lead + (-1, 9)))
        wsum = self.vol.new_zeros(n).index_add(
            0, idx, self.vol.repeat_interleave(4))
        acc = (acc / torch.clamp_min(wsum, 1e-12)[:, None]).reshape(
            lead + (n, 3, 3))
        ok = _cofactor_t(acc)[1] > 1e-8
        I3 = torch.eye(3, dtype=acc.dtype, device=acc.device)
        return _polar_rotations(torch.where(ok[..., None, None], acc, I3))

    def _gather(self, w):
        """(..., 3n) -> the element vertices' (..., E, 4, 3)."""
        return w.reshape(w.shape[:-1] + (-1, 3))[..., self.tets, :]

    def _scatter(self, fe):
        """Element vertex forces (..., E, 4, 3) summed onto the nodes,
        (..., 3n), zeroed on fixed dofs."""
        lead = fe.shape[:-3]
        f = fe.new_zeros(lead + (self.n_nodes, 3)).index_add(
            -2, self.tets.reshape(-1), fe.reshape(lead + (-1, 3)))
        return f.reshape(lead + (-1,)) * self.free_mask

    def _ke(self, d):
        """K_e d_e for element vectors d (..., E, 4, 3)."""
        lead = d.shape[:-3]
        E = d.shape[-3]
        kd = torch.einsum("eij,kej->kei", self.Ke, d.reshape(-1, E, 12))
        return kd.reshape(lead + (E, 4, 3))

    def f_int(self, q):
        """Corotational internal force (..., 3n), zeroed on fixed dofs:
        f_e = -R_e K_e (R_e^T x_e - x_e^rest), the material law of SOFA's
        TetrahedronFEMForceField method='large'
        (robots/environments.py:55,184)."""
        q = self._t(q)
        return self._f_int_frozen(q, self.rotations(q))

    def _f_int_frozen(self, q, R):
        loc = self._gather(q) @ R           # R_e^T applied to each vertex
        floc = -self._ke(loc - self._gather(self.rest_pos))
        return self._scatter(floc @ R.transpose(-1, -2))

    def kt_frozen_matvec(self, w, R):
        """Corotational-tangent matvec K_t w = sum_e R_e K_e R_e^T w with the
        rotations frozen (SPD); the per-step PCG's operator (the same
        tangent SOFA assembles). w (..., 3n) with R of the same leading
        axes or of none."""
        kl = self._ke(self._gather(w) @ R)
        return self._scatter(kl @ R.transpose(-1, -2))

    # forces ------------------------------------------------------------
    def force(self, q, v, u):
        """Total force: elastic + gravity + cables - Rayleigh damping with
        the current tangent (D = alpha M + beta K_t,
        robots/environments.py:23-26)."""
        q, v, u = self._t(q), self._t(v), self._t(u)
        R = self.rotations(q)
        f = (self._f_int_frozen(q, R) + self.m_node * self.g_full
             + u @ self.H.T - self.alpha * self.m_node * v
             - self.beta * self.kt_frozen_matvec(v, R))
        return f * self.free_mask

    def f(self, x, u):
        """Continuous dynamics xdot = [vdot; qdot], x = [v; q]."""
        q, v = x2qv(self._t(x))
        acc = self.force(q, v, u) / self.m_node
        return qv2x(v * self.free_mask, acc)

    # stepping ------------------------------------------------------------
    def _prec(self, r, Rn):
        """The rest step matrix's inverse S_q diag(1/S_lam) S_q^T applied in
        the rotated node frames Rn (..., n, 3, 3) or (n, 3, 3), r (..., 3n):
        two dense products for all of r's rows at once."""
        lead, fm = r.shape[:-1], self.free_mask
        rl = torch.einsum("...nji,...nj->...ni", Rn,
                          r.reshape(lead + (-1, 3))).reshape(r.shape) * fm
        zl = (((rl @ self.S_q) / self.S_lam) @ self.S_q.T) * fm
        z = torch.einsum("...nij,...nj->...ni", Rn,
                         zl.reshape(lead + (-1, 3)))
        return z.reshape(r.shape) * fm

    def step(self, x, u, dt):
        """Linearly implicit Euler (SOFA's EulerImplicitSolver form) with
        the current corotational tangent:

            (M + dt*D + dt^2*K_t) dv = dt*(f(q,v,u) - dt*K_t v)

        solved matrix-free by PCG with the node-rotated rest factor as
        preconditioner. x (..., 2n): each state stops at the iteration it
        takes alone. dt must equal `self.dt` (the factor's step size)."""
        return self.step_iters(x, u, dt)[0]

    def step_iters(self, x, u, dt):
        """`step` and the PCG iterations each state took, (x+, its (...))."""
        x, u = self._t(x), self._t(u)
        q, v = x2qv(x)
        fm = self.free_mask
        R = self.rotations(q)
        Rn = self.node_rotations(R)
        Kv = self.kt_frozen_matvec(v, R)
        f = (self._f_int_frozen(q, R) + self.m_node * self.g_full
             + u @ self.H.T - self.alpha * self.m_node * v - self.beta * Kv)
        rhs = dt * (f * fm - dt * Kv) * fm
        c_mass = (1.0 + dt * self.alpha) * self.m_node
        c_stiff = dt * self.beta + dt * dt
        dv, its = _pcg(
            lambda w: c_mass * w + c_stiff * self.kt_frozen_matvec(w, R),
            lambda r: self._prec(r, Rn), rhs, self.cg_iters, self.cg_tol)
        v2 = (v + dv) * fm
        q2 = q + dt * v2
        return qv2x(q2, v2), its

    def solve_st_multi(self, B_cols, R, Rn):
        """S_t^{-1} B for a block of right-hand sides B_cols (3n, k), with
        S_t = (1+dt*alpha) M + (dt*beta+dt^2) K_t(R): batched PCG with the
        node-rotated rest preconditioner, all k columns in one product an
        iteration. As in the JAX package, every column iterates until the
        slowest one converges."""
        return self.solve_st_multi_iters(B_cols, R, Rn)[0]

    def solve_st_multi_iters(self, B_cols, R, Rn):
        """`solve_st_multi` and its iteration count (a 0-d tensor)."""
        dt = self.dt
        c_mass = (1.0 + dt * self.alpha) * self.m_node
        c_stiff = dt * self.beta + dt * dt
        B = self._t(B_cols).T * self.free_mask     # columns as rows (k, 3n)
        X, its = _pcg(
            lambda w: c_mass * w + c_stiff * self.kt_frozen_matvec(w, R),
            lambda r: self._prec(r, Rn), B, self.cg_iters, self.cg_tol,
            together=True)
        return X.T, its

    def reduced_discrete_dynamics(self, rom, x, u, dt, x_next_r=None):
        """ROM-projected discrete affine dynamics (A_d, B_d, d_d) of the
        plant's own linearly implicit step (the reference's discrete TPWL
        from SOFA's implicit system matrix, extract_AB_d,
        sofacontrol/utils.py:289-299). With v+ = v + S^-1 dt (f - dt K_t v),
        q+ = q + dt v+ and rotations frozen,

            dv+/dv = S^-1 M,  dv+/dq = -dt S^-1 K_t,  dv+/du = dt S^-1 H,

        so one multi-column PCG solve with (2r + m) right-hand sides yields
        the projected step Jacobians. d_d makes the map exact at the point:
        pass x_next_r (recorded next reduced state) when sweeping a
        recorded trajectory, else one plant step is taken. One point (x
        (2n,), u (m,))."""
        x, u = self._t(x), self._t(u)
        q, _ = x2qv(x)
        U = self._t(rom.U)
        r = U.shape[1]
        R = self.rotations(q)
        Rn = self.node_rotations(R)
        fm = self.free_mask[:, None]
        Um = U * fm
        KU = self.kt_frozen_matvec(Um.T, R).T
        B_cols = torch.cat([self.m_node * Um, KU * fm, self.H * fm], dim=1)
        sol = self.solve_st_multi(B_cols, R, Rn)
        Avv = U.T @ sol[:, :r]
        Avq = -dt * (U.T @ sol[:, r:2 * r])
        Bv = dt * (U.T @ sol[:, 2 * r:])
        Ir = torch.eye(r, dtype=x.dtype, device=x.device)
        A_d = torch.cat([torch.cat([Avv, Avq], 1),
                         torch.cat([dt * Avv, Ir + dt * Avq], 1)], 0)
        B_d = torch.cat([Bv, dt * Bv], dim=0)
        if x_next_r is None:
            x_next_r = rom.project_x(self.step(x, u, dt))
        x_r = self._t(rom.project_x(x))
        d_d = self._t(x_next_r) - A_d @ x_r - B_d @ u
        return A_d, B_d, d_d

    # Jacobians -----------------------------------------------------------
    def kt_matvec(self, q, w):
        """Exact tangent-stiffness matvec K_t(q) w (including rotation
        derivatives), matrix-free by a jvp of the corotational force; w
        (3n,) or columns as rows (k, 3n) at one q (3n,)."""
        q, w = self._t(q), self._t(w)

        def df(wi):
            return torch.func.jvp(self.f_int, (q,), (wi,))[1]

        return -(df(w) if w.dim() == 1 else torch.func.vmap(df)(w))

    def jacobians(self, x, u):
        """Dense (A, B, d), only sensible for small meshes; the pipeline
        uses reduced_affine_dynamics at scale. x (..., 2n), u (..., m)."""
        if self.n_nodes > 400:
            raise NotImplementedError(
                "dense state Jacobian at this mesh scale would be "
                f"({self.state_dim}x{self.state_dim}); use "
                "reduced_affine_dynamics")
        x, u = self._t(x), self._t(u)
        if x.dim() > 1:
            return _stacked(self.jacobians, x, u)
        q, _ = x2qv(x)
        n = self.n_nodes_dof
        fm = self.free_mask[:, None]
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        Kt = self.kt_matvec(q, eye).T
        Kc = self.kt_frozen_matvec(eye, self.rotations(q)).T
        Minv = 1.0 / self.m_node
        A = torch.zeros((2 * n, 2 * n), dtype=x.dtype, device=x.device)
        A[:n, :n] = -Minv * (self.alpha * self.m_node * eye
                             + self.beta * Kc) * fm
        A[:n, n:] = -Minv * Kt * fm
        A[n:, :n] = torch.diag(self.free_mask)
        B = torch.cat((Minv * self.H * fm, torch.zeros_like(self.H)), dim=0)
        d = self.f(x, u) - A @ x - B @ u
        return A, B, d

    def reduced_affine_dynamics(self, rom, x, u):
        """ROM-projected affine dynamics (A_r, B_r, d_r) at (x, u) without
        materializing the full Jacobian: U^T K_t U through r jvp's of the
        element-force sweep (the reference's LDL export + extract_AB +
        compute_RO_matrix chain, sofacontrol/utils.py:180-299,
        mor/pod.py:56-79). x (..., 2n) and u (..., m): one projection a
        point."""
        x, u = self._t(x), self._t(u)
        if x.dim() > 1:
            return _stacked(lambda xi, ui: self.reduced_affine_dynamics(
                rom, xi, ui), x, u)
        q, _ = x2qv(x)
        U = self._t(rom.U)  # (3n, r)
        r = U.shape[1]
        Um = U * self.free_mask[:, None]
        KtU = self.kt_matvec(q, Um.T).T
        KcU = self.kt_frozen_matvec(Um.T, self.rotations(q)).T
        UtKtU = U.T @ KtU                                # (r, r)
        UtKcU = U.T @ KcU
        Minv = 1.0 / self.m_node
        Ir = torch.eye(r, dtype=x.dtype, device=x.device)
        A_r = torch.zeros((2 * r, 2 * r), dtype=x.dtype, device=x.device)
        A_r[:r, :r] = -(self.alpha * Ir + self.beta * Minv * UtKcU)
        A_r[:r, r:] = -Minv * UtKtU
        A_r[r:, :r] = Ir
        B_r = torch.cat((Minv * (U.T @ (self.H * self.free_mask[:, None])),
                         torch.zeros((r, self.H.shape[1]), dtype=x.dtype,
                                     device=x.device)), dim=0)
        qdot, vdot = x2qv(self.f(x, u))  # (second half, first half)
        f_r = torch.cat((U.T @ vdot, U.T @ qdot))
        x_r = self._t(rom.project_x(x))
        d_r = f_r - A_r @ x_r - B_r @ u
        return A_r, B_r, d_r


def _stacked(fn, X, U):
    """fn at each point of X (k, 2n), U (k, m), its outputs stacked."""
    return tuple(torch.stack(a) for a in zip(*(fn(x, u)
                                               for x, u in zip(X, U))))


# ---------------------------------------------------------------------------
# Builders


def _element_stiffness(rest_pos, tets, Bm, vol, mu, lam):
    """Rest element stiffnesses K_e (E,12,12) = -d f_e/d x_e of the linear
    element force at the rest configuration (symmetric PSD), by a batched
    jacfwd on the CPU in f64; numpy."""

    def elem_force_flat(xe, Bm_e, vol_e):
        f = _linear_element_forces(xe.reshape(1, 4, 3), Bm_e[None],
                                   vol_e[None], mu, lam)
        return f.reshape(12)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    jac = torch.func.vmap(torch.func.jacfwd(elem_force_flat))
    Ke = -jac(t(rest_pos.reshape(-1, 3)[tets].reshape(-1, 12)), t(Bm),
              t(vol)).numpy()
    return 0.5 * (Ke + np.swapaxes(Ke, 1, 2))  # symmetrize exactly


def _assemble_k0(Ke, tets, n_nodes, dtype):
    """Dense rest tangent stiffness (3n,3n) scattered from the element
    stiffnesses on host (build time only)."""
    dof = (3 * tets[:, :, None] + np.arange(3)[None, None, :]).reshape(-1, 12)
    n3 = 3 * n_nodes
    K = np.zeros((n3, n3), dtype=np.float64)
    rows = np.repeat(dof, 12, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 12)).reshape(-1)
    np.add.at(K, (rows, cols), Ke.reshape(-1))
    return K.astype(dtype)


def _step_factor(K0, free_mask, m_node, alpha, beta, dt, device):
    """Eigendecomposition (S_lam, S_q) of the rest step matrix S = (1 + dt
    alpha) M + (dt beta + dt^2) K0, its fixed dofs decoupled with the
    diagonal m_node, in f64 on `device` (the JAX package's host eigh)."""
    S = torch.as_tensor(K0, dtype=torch.float64, device=device) * (
        dt * beta + dt * dt)
    S.diagonal().add_((1.0 + dt * alpha) * m_node)
    free = torch.as_tensor(free_mask, dtype=torch.float64, device=device)
    S = S * free[:, None] * free[None, :]
    S.diagonal().add_((1.0 - free) * m_node)
    return torch.linalg.eigh(S)


def _bary_embed(points: np.ndarray, tets: np.ndarray, query: np.ndarray):
    """Barycentric embedding of query points (k,3) into the tet mesh:
    returns (tet_idx (k,), bary (k,4)). Picks the least-violating tet; a
    point far outside any tet snaps to its nearest mesh node (the role of
    SOFA's BarycentricMapping for the cable attachment points)."""
    p0 = points[tets[:, 0]]  # (E,3)
    Dm = np.stack([points[tets[:, 1]] - p0, points[tets[:, 2]] - p0,
                   points[tets[:, 3]] - p0], axis=-1)
    Dm_inv = np.linalg.inv(Dm)  # (E,3,3)
    idx, bary = [], []
    for pq in query:
        b123 = np.einsum("eij,ej->ei", Dm_inv, pq[None] - p0)  # (E,3)
        b = np.concatenate([(1.0 - b123.sum(axis=1))[:, None], b123], axis=1)
        viol = -np.minimum(b.min(axis=1), 0.0)
        e = int(np.argmin(viol))
        if viol[e] > 0.25:  # outside the mesh: nearest node
            node = int(np.argmin(np.linalg.norm(points - pq, axis=1)))
            local = tets[np.any(tets == node, axis=1)][0]
            e = int(np.where(np.all(tets == local, axis=1))[0][0])
            bb = np.zeros(4)
            bb[list(local).index(node)] = 1.0
            idx.append(e)
            bary.append(bb)
        else:
            idx.append(e)
            bary.append(b[e])
    return np.asarray(idx), np.asarray(bary)


def _cable_column(points, tets, waypoints, pull_point=None):
    """One H column (3n,) for unit cable tension.

    With a pull point (Diamond, environments.py:196-238): force at each
    geometry point toward the pull point. Without (Trunk polyline cables,
    environments.py:70-137): tension along the polyline, each waypoint
    pulled toward its neighbors."""
    wp = np.asarray(waypoints, dtype=np.float64)
    n = points.shape[0]
    col = np.zeros(3 * n)
    forces = np.zeros_like(wp)
    if pull_point is not None:
        for j in range(wp.shape[0]):
            d = np.asarray(pull_point) - wp[j]
            forces[j] = d / np.linalg.norm(d)
    else:
        for j in range(wp.shape[0]):
            for k in (j - 1, j + 1):
                if 0 <= k < wp.shape[0]:
                    d = wp[k] - wp[j]
                    forces[j] += d / np.linalg.norm(d)
    eidx, bary = _bary_embed(points, tets, wp)
    for j in range(wp.shape[0]):
        for vloc in range(4):
            node = tets[eidx[j], vloc]
            col[3 * node:3 * node + 3] += bary[j, vloc] * forces[j]
    return col


def _settle(plant: TetFEM, settle_time: float):
    """The equilibrium q after settle_time of zero input from x_rest."""
    from soft_robot_control_tpu_torch.sim.fem_surrogate import simulate

    T = int(round(settle_time / plant.dt))
    u0 = torch.zeros((T, plant.input_dim), dtype=plant.dtype,
                     device=plant.device)
    return simulate(plant, plant.x_rest(), u0, plant.dt)[-1,
                                                         plant.n_nodes_dof:]


def with_young_scale(plant: TetFEM, s: float, alpha: float = None,
                     settle_time: float = 0.0) -> TetFEM:
    """A plant with Young's modulus scaled by `s` (and optionally a new
    Rayleigh alpha) WITHOUT re-assembling or re-eigendecomposing.

    Because the lumped mass is a scalar multiple of the identity, the step
    matrix S(s) = (1+dt*a)*m*I + (dt*b+dt^2)*s*K0 commutes with K0 and
    shares its eigenvectors: only the eigenvalues shift. The settle runs
    from the mesh's rest positions."""
    dt = plant.dt
    m = float(plant.m_node)
    a_old = float(plant.alpha)
    a_new = a_old if alpha is None else float(alpha)
    c1o, c2o = 1.0 + dt * a_old, dt * float(plant.beta) + dt * dt
    c1n, c2n = 1.0 + dt * a_new, c2o
    # recover K0 eigenvalues on the shared eigenvectors, then rebuild S's
    lam_k = (plant.S_lam - c1o * m) / c2o
    new = copy.copy(plant)
    new.Ke = plant.Ke * s
    new.K0 = plant.K0 * s
    new.alpha = float(_numpy_dtype(plant.dtype).type(a_new))
    new.S_lam = torch.clamp_min(c1n * m + c2n * s * lam_k, 1e-8 * m)
    if settle_time > 0.0:
        new.q_eq = new.rest_pos
        new.q_eq = _settle(new, settle_time)
    return new


PLANT_CACHE_DIR = os.path.join(_REPO, "build", "plant_cache")


def _save_plant(plant: TetFEM, path: str) -> None:
    """Atomic write (tmp + rename) in the JAX package's layout (leaf0..14
    and aux = (dt, cg_iters, cg_tol)): a process killed mid-write must
    never leave a truncated npz at the cache path."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}.npz"  # np.savez appends .npz itself
    arrays = _leaf_arrays(plant)
    try:
        np.savez_compressed(
            tmp, aux=np.asarray((plant.dt, plant.cg_iters, plant.cg_tol),
                                dtype=np.float64),
            **{f"leaf{i}": arrays[k] for i, k in enumerate(LEAVES)})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _leaf_arrays(plant) -> dict:
    """The 15 leaves of a plant (this package's or the JAX package's) as
    numpy arrays: the element indices int32, m_node, alpha and beta 0-d
    arrays of the float leaves' dtype."""
    out = {k: to_numpy(getattr(plant, k)) for k in LEAVES}
    for k in _SCALARS:
        out[k] = np.asarray(out[k], dtype=out["rest_pos"].dtype)
    out["tets"] = out["tets"].astype(np.int32)
    return out


def _load_plant(path: str, device="cuda") -> TetFEM:
    """Raises on any corruption; callers catch and rebuild."""
    z = np.load(path)
    leaves = [z[f"leaf{i}"] for i in range(len(z.files) - 1)]
    if len(leaves) != len(LEAVES):
        raise ValueError(f"{path} holds {len(leaves)} leaves, not "
                         f"{len(LEAVES)}")
    dt, cg_iters, cg_tol = z["aux"]
    return TetFEM(*leaves, float(dt), int(cg_iters), float(cg_tol),
                  device=device)


def _load_plant_or_evict(path: str, device="cuda"):
    """Load a cached plant; on any failure (truncated zip, missing keys,
    bad shapes) evict the corrupt file and return None so the caller
    rebuilds instead of failing forever."""
    try:
        return _load_plant(path, device)
    except Exception as e:  # noqa: BLE001 (any corruption means rebuild)
        warnings.warn(f"corrupt plant cache {path} ({e!r}); rebuilding")
        try:
            os.remove(path)
        except OSError:
            pass
        return None


def build_tet_fem(points: np.ndarray, tets: np.ndarray, *, young: float,
                  poisson: float, total_mass: float, alpha: float,
                  beta: float, fixed_box, cables, dt: float,
                  gravity=(0.0, 0.0, 0.0), settle_time: float = 0.0,
                  dtype=np.float64, device="cuda") -> TetFEM:
    """Assemble a TetFEM plant on `device` in `dtype` (numpy or torch).

    fixed_box: (xmin, ymin, zmin, xmax, ymax, zmax); nodes inside are
    Dirichlet-fixed (the BoxROI + RestShapeSpringsForceField pattern,
    robots/environments.py:61-63,188-190). cables: list of dicts with
    'waypoints' (k,3) and optional 'pull_point' (3,). settle_time > 0 runs
    the plant under zero input to find the post-gravity equilibrium (the
    reference's rest.pkl, environments.py:160-168). The element
    stiffnesses and K0 are built on the host in f64, the step matrix's
    eigendecomposition in f64 on `device`."""
    dev = resolve_device(device)
    np_dt = _numpy_dtype(dtype)
    points = np.asarray(points, dtype=np.float64)
    tets, Bm, vol = _tet_precompute(points, np.asarray(tets))
    n = points.shape[0]
    mu = young / (2.0 * (1.0 + poisson))
    lam = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    m_node = total_mass / n

    lo, hi = np.asarray(fixed_box[:3]), np.asarray(fixed_box[3:])
    fixed = np.all((points >= lo) & (points <= hi), axis=1)
    free_mask = np.repeat(~fixed, 3).astype(np.float64)

    H = np.stack([_cable_column(points, tets, c["waypoints"],
                                c.get("pull_point")) for c in cables], axis=1)
    H *= free_mask[:, None]

    Ke = _element_stiffness(points.reshape(-1), tets, Bm, vol, mu, lam)
    K0 = _assemble_k0(Ke, tets, n, np.float64)
    K0 = K0 * free_mask[:, None] * free_mask[None, :]
    S_lam, S_q = _step_factor(K0, free_mask, m_node, alpha, beta, dt, dev)

    g_full = np.tile(np.asarray(gravity, dtype=np.float64), n) * free_mask
    rest = points.reshape(-1).astype(np_dt)
    plant = TetFEM(rest, tets, Bm.astype(np_dt), vol.astype(np_dt),
                   Ke.astype(np_dt), np_dt.type(m_node), np_dt.type(alpha),
                   np_dt.type(beta), free_mask.astype(np_dt), H.astype(np_dt),
                   K0.astype(np_dt), S_q, S_lam, g_full.astype(np_dt), rest,
                   dt, device=dev, dtype=np_dt)

    if settle_time > 0.0 and np.any(np.asarray(gravity) != 0.0):
        plant.q_eq = _settle(plant, settle_time)
    return plant


# ---------------------------------------------------------------------------
# Reference robots


def diamond_cables():
    """The four Diamond cables: single attachment point + pull point, scene
    frame (robots/environments.py:196-215)."""
    params = [([0, 97, 45], [0, 10, 30]), ([-97, 0, 45], [-10, 0, 30]),
              ([0, -97, 45], [0, -10, 30]), ([97, 0, 45], [10, 0, 30])]
    return [{"waypoints": np.asarray([a], dtype=np.float64),
             "pull_point": np.asarray(p, dtype=np.float64)}
            for a, p in params]


def trunk_cables():
    """The eight Trunk polyline cables (4 long, 4 short), replicating the
    Quat/Vec3 waypoint construction of robots/environments.py:70-137."""
    length1, length2, length_trunk = 10.0, 2.0, 195.0
    direction = np.array([0.0, length2 - length1, length_trunk])
    direction /= np.linalg.norm(direction)
    pull = [[0.0, length1, 0.0], [-length1, 0.0, 0.0],
            [0.0, -length1, 0.0], [length1, 0.0, 0.0]]

    def rot_z(theta, v):
        c, s = np.cos(theta), np.sin(theta)
        return np.array([c * v[0] - s * v[1], s * v[0] + c * v[1], v[2]])

    cables = []
    for n_pts, n_idx in ((20, 21), (10, 10)):
        for i in range(4):
            theta = 1.57 * i
            pts = []
            for k in range(0, n_pts, 2):
                for z_off in (21.0, 27.0):
                    v = np.array([direction[0],
                                  direction[1] * 17.5 * (k / 2) + length1,
                                  direction[2] * 17.5 * (k / 2) + z_off])
                    pts.append(rot_z(theta, v))
            wp = np.asarray([pull[i]] + pts)[:n_idx]
            cables.append({"waypoints": wp})
    return cables


def _cached_build(key, mesh_path, cache, device, build):
    """build() through the plant cache: a cached plant when the mesh is
    the default one and the file loads, else a fresh build, saved."""
    cpath = os.path.join(PLANT_CACHE_DIR, key)
    use_cache = cache and mesh_path is None
    if use_cache and os.path.exists(cpath):
        cached = _load_plant_or_evict(cpath, device)
        if cached is not None:
            return cached
    plant = build()
    if use_cache:
        _save_plant(plant, cpath)
    return plant


def diamond_tet_fem(*, young: float = 175.0, poisson: float = 0.45,
                    total_mass: float = 0.45, alpha: float = 2.5,
                    beta: float = 0.01, dt: float = 0.01,
                    gravity_on: bool = True, settle_time: float = 1.5,
                    mesh_path: str = None, dtype=np.float64,
                    cache: bool = True, device="cuda") -> TetFEM:
    """The hardware-calibrated Diamond (examples/hardware/model.py:28-45)
    over the shipped diamond.vtu (or the ASCII .vtu at mesh_path): 1628
    nodes -> 9768-dim state, 4 cables, rotation [90,0,0] + translation
    [0,0,35], BoxROI base fix (robots/environments.py:139-238)."""
    resolve_device(device)
    key = (f"diamond_{young}_{poisson}_{total_mass}_{alpha}_{beta}_{dt}_"
           f"{gravity_on}_{settle_time}_{_numpy_dtype(dtype).name}.npz")

    def build():
        pts, tets = load_vtu_ascii(
            mesh_path or os.path.join(REFERENCE_MESH_DIR, "diamond.vtu"))
        pts = transform_mesh(pts, rotation_deg=(90.0, 0.0, 0.0),
                             translation=(0.0, 0.0, 35.0))
        g = (0.0, 0.0, -9810.0) if gravity_on else (0.0, 0.0, 0.0)
        return build_tet_fem(
            pts, tets, young=young, poisson=poisson, total_mass=total_mass,
            alpha=alpha, beta=beta,
            fixed_box=(-15.0, -15.0, -40.0, 15.0, 15.0, 10.0),
            cables=diamond_cables(), dt=dt, gravity=g,
            settle_time=settle_time if gravity_on else 0.0, dtype=dtype,
            device=device)

    return _cached_build(key, mesh_path, cache, device, build)


def trunk_tet_fem(*, young: float = 450.0, poisson: float = 0.45,
                  total_mass: float = 0.042, alpha: float = 0.1,
                  beta: float = 0.1, dt: float = 0.01,
                  gravity_on: bool = True, settle_time: float = 1.5,
                  mesh_path: str = None, dtype=np.float64,
                  cache: bool = True, device="cuda") -> TetFEM:
    """The Trunk (robots/environments.py:39-137) over the shipped trunk.vtk
    (or the legacy .vtk at mesh_path): 709 nodes -> 4254-dim state, 8
    polyline cables, base fixed in [[-20,-20,0],[20,20,20]]."""
    resolve_device(device)
    key = (f"trunk_{young}_{poisson}_{total_mass}_{alpha}_{beta}_{dt}_"
           f"{gravity_on}_{settle_time}_{_numpy_dtype(dtype).name}.npz")

    def build():
        pts, tets = load_vtk_legacy(
            mesh_path or os.path.join(REFERENCE_MESH_DIR, "trunk.vtk"))
        g = (0.0, 0.0, 9810.0) if gravity_on else (0.0, 0.0, 0.0)
        return build_tet_fem(
            pts, tets, young=young, poisson=poisson, total_mass=total_mass,
            alpha=alpha, beta=beta,
            fixed_box=(-20.0, -20.0, 0.0, 20.0, 20.0, 20.0),
            cables=trunk_cables(), dt=dt, gravity=g,
            settle_time=settle_time if gravity_on else 0.0, dtype=dtype,
            device=device)

    return _cached_build(key, mesh_path, cache, device, build)


def make_box_mesh(nx: int = 3, ny: int = 3, nz: int = 5, spacing: float = 10.0):
    """Small synthetic box tet mesh (each grid cell split into 5 tets) for
    fast tests: the same element machinery as the reference meshes without
    the multi-second build."""
    xs = np.arange(nx) * spacing
    ys = np.arange(ny) * spacing
    zs = np.arange(nz) * spacing
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"),
                   axis=-1).reshape(-1, 3)

    def nid(i, j, k):
        return (i * ny + j) * nz + k

    tets = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            for k in range(nz - 1):
                v = [nid(i, j, k), nid(i + 1, j, k), nid(i, j + 1, k),
                     nid(i + 1, j + 1, k), nid(i, j, k + 1),
                     nid(i + 1, j, k + 1), nid(i, j + 1, k + 1),
                     nid(i + 1, j + 1, k + 1)]
                if (i + j + k) % 2 == 0:
                    cells = [(0, 1, 3, 5), (0, 3, 2, 6), (0, 5, 6, 4),
                             (3, 5, 6, 7), (0, 3, 6, 5)]
                else:
                    cells = [(1, 0, 2, 4), (1, 2, 3, 7), (1, 4, 7, 5),
                             (2, 4, 6, 7), (1, 2, 7, 4)]
                tets.extend([tuple(v[c] for c in cell) for cell in cells])
    return pts.astype(np.float64), np.asarray(tets, dtype=np.int32)
