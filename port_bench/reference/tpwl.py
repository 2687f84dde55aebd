"""A TPWL dictionary and its nearest-point dynamics, from the raw files.

The dictionary pickle holds the points (q, v), their discrete dynamics
(A_d, B_d, d_d) at its own dt, and the POD basis. The measurement and
output maps are node selections of the full state x_f = [v; q] (three
coordinates a node, the velocity block first), so C = Cf V and H = Hf V are
rows of the basis; they are built here from the node lists of the
configuration.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from .numerics import Numerics


@dataclass
class Dictionary:
    q: torch.Tensor       # (P, r) points' reduced positions
    v: torch.Tensor       # (P, r) and velocities; a state is x = [v; q]
    A: torch.Tensor       # (P, n, n) discrete dynamics at each point
    B: torch.Tensor       # (P, n, m)
    d: torch.Tensor       # (P, n)
    C: torch.Tensor       # (n_y, n) measurement map, y = C x + y_ref
    y_ref: torch.Tensor
    H: torch.Tensor       # (n_z, n) output map, z = H x + z_ref
    z_ref: torch.Tensor
    w_q: float            # distance weights
    w_v: float
    dt: float
    Ac: torch.Tensor = None   # (P, n, n) continuous dynamics at each point
    Bc: torch.Tensor = None
    dc: torch.Tensor = None

    @property
    def n_x(self) -> int:
        return self.A.shape[1]

    @property
    def n_u(self) -> int:
        return self.B.shape[2]

    @property
    def num_points(self) -> int:
        return self.q.shape[0]


# the keys a configuration may hold, and what the reference reads of them
CONFIG_KEYS = {
    # descriptive: what the deployment is and where it comes from
    "name", "source", "deployment", "reference", "assumed", "reduced",
    # the dictionary and its sizes, checked against the pickle
    "dictionary", "points", "rom_dim", "state_dim", "cables", "num_nodes",
    # the cable box, the maps, the distance and the program's dtype
    "u_lb", "u_ub", "measurement_nodes", "output_nodes", "dist_weights",
    "dtype",
    # the settings of each kind of traffic (entries/*.py check their own)
    "mpc", "gusto",
}


def check_config(cfg: dict) -> dict:
    """`cfg` if it holds only keys the benchmark reads; raises otherwise,
    so that a setting the reference would ignore cannot pass unseen."""
    unknown = sorted(set(cfg) - CONFIG_KEYS)
    if unknown:
        raise ValueError(f"configuration {cfg.get('name')!r}: keys "
                         f"{unknown} are read by neither the program's "
                         f"driver nor the reference")
    return cfg


def check_settings(where: str, got: dict, supported: dict) -> dict:
    """`got` (a configuration's settings group) if each key is one the
    reference implements and, where `supported` names values, one of
    them; raises otherwise."""
    unknown = sorted(set(got) - set(supported))
    if unknown:
        raise ValueError(f"{where}: the reference does not implement the "
                         f"settings {unknown}")
    for k, values in supported.items():
        if values is not None and k in got and got[k] not in values:
            raise ValueError(f"{where}: the reference implements {k} in "
                             f"{list(values)}, not {got[k]!r}")
    return got


def read_raw(cfg: dict, root: str) -> dict:
    """The configuration's dictionary pickle, its sizes checked against the
    configuration's `points`, `rom_dim`, `state_dim`, `cables` and
    `num_nodes`, and its dt against the settings' `dt`: the reference takes
    the dictionary's own discrete dynamics, so nothing discretizes."""
    check_config(cfg)
    with open(os.path.join(root, cfg["dictionary"]), "rb") as f:
        raw = pickle.load(f)
    P, r, n, m = (cfg["points"], cfg["rom_dim"], cfg["state_dim"],
                  cfg["cables"])
    shapes = {"q": (P, r), "v": (P, r), "A_d": (P, n, n), "B_d": (P, n, m),
              "d_d": (P, n), "A_c": (P, n, n), "B_c": (P, n, m),
              "d_c": (P, n), "U": (3 * cfg["num_nodes"], r)}
    for k, want in shapes.items():
        got = tuple(np.shape(raw["rom_info"]["U"] if k == "U" else raw[k]))
        if got != want:
            raise ValueError(f"{cfg['dictionary']}: {k} is {got}, the "
                             f"configuration {cfg['name']!r} says {want}")
    for group in ("mpc", "gusto"):
        dt = cfg.get(group, {}).get("dt")
        if dt is not None and abs(float(raw["dt"]) - dt) > 1e-12:
            raise ValueError(f"{group}.dt {dt} is not the dictionary's "
                             f"{raw['dt']}: the reference has no "
                             "discretization of its own")
    return raw


def node_rows(U, ref, nodes):
    """Rows 3 node + k (k = 0, 1, 2) of the basis U and of the reference
    state, for each node in turn."""
    idx = np.asarray([3 * n + k for n in nodes for k in range(3)])
    return U[idx], ref[idx]


def output_map(U, q_ref, v_ref, nodes, pos=True, vel=True):
    """(M, m_ref) of y = M x + m_ref for the selected nodes' velocities
    (first) and positions, x = [v; q] with r coordinates each."""
    rows, refs = [], []
    if vel:
        Uv, rv = node_rows(U, v_ref, nodes)
        rows.append(np.concatenate([Uv, np.zeros_like(Uv)], axis=1))
        refs.append(rv)
    if pos:
        Uq, rq = node_rows(U, q_ref, nodes)
        rows.append(np.concatenate([np.zeros_like(Uq), Uq], axis=1))
        refs.append(rq)
    return np.concatenate(rows, axis=0), np.concatenate(refs)


def load_dictionary(cfg: dict, root: str, device, num: Numerics,
                    raw: dict = None, continuous: bool = True) -> Dictionary:
    """The dictionary of a configuration (its `dictionary`, `dist_weights`,
    `measurement_nodes`, `output_nodes`), in `num`'s dtype on `device`,
    from `raw` (read_raw's) or read anew; without the continuous dynamics
    where `continuous` is false."""
    raw = read_raw(cfg, root) if raw is None else raw
    info = raw["rom_info"]
    if info["type"] != "POD":
        raise ValueError("the dictionary's basis is not POD")
    U = np.asarray(info["U"], dtype=np.float64)
    q_ref = np.asarray(info["q_ref"], dtype=np.float64)
    v_ref = np.asarray(info["v_ref"], dtype=np.float64)
    C, y_ref = output_map(U, q_ref, v_ref, cfg["measurement_nodes"])
    H, z_ref = output_map(U, q_ref, v_ref, cfg["output_nodes"], vel=False)
    t = lambda a: num.t(np.asarray(a), device)
    dw = cfg["dist_weights"]
    cont = ({"Ac": t(raw["A_c"]), "Bc": t(raw["B_c"]), "dc": t(raw["d_c"])}
            if continuous else {})
    return Dictionary(q=t(raw["q"]), v=t(raw["v"]), A=t(raw["A_d"]),
                      B=t(raw["B_d"]), d=t(raw["d_d"]), C=t(C),
                      y_ref=t(y_ref), H=t(H), z_ref=t(z_ref),
                      w_q=float(dw["q"]), w_v=float(dw["v"]),
                      dt=float(raw["dt"]), **cont)


def distances(dic: Dictionary, x):
    """(S, P) weighted distances w_q |q - q_i| + w_v |v - v_i| of the states
    x (S, 2r), by direct differences."""
    r = dic.q.shape[1]
    exact = "donot_use_mm_for_euclid_dist"
    return (dic.w_q * torch.cdist(x[:, r:], dic.q, compute_mode=exact)
            + dic.w_v * torch.cdist(x[:, :r], dic.v, compute_mode=exact))


def nearest(dic: Dictionary, x, chunk: int = 8192):
    """Index of each state's nearest point (ties to the lowest), in blocks
    of `chunk` states."""
    return torch.cat([torch.argmin(distances(dic, x[s:s + chunk]), dim=1)
                      for s in range(0, x.shape[0], chunk)])


def step(dic: Dictionary, num: Numerics, x, u, i):
    """x+ = A_i x + B_i u + d_i."""
    return num.mv(dic.A[i], x) + num.mv(dic.B[i], u) + dic.d[i]


def rollout(dic: Dictionary, num: Numerics, x0, u):
    """States (S, T+1, n) of the nearest-point dynamics from x0 (S, n) under
    u (S, T, m)."""
    X = num.t(x0)
    u = num.t(u)
    xs = [X]
    for k in range(u.shape[1]):
        X = step(dic, num, X, u[:, k], nearest(dic, X))
        xs.append(X)
    return torch.stack(xs, dim=1)


def next_states(dic: Dictionary, num: Numerics, x, u, k: int = 3):
    """The step from each state x (S, n) under u (S, m) at each of its k
    nearest points (S, k, n), and each of those points' relative distance
    gap to the nearest, (d_j - d_1) / d_1 (S, k)."""
    dist = distances(dic, x)
    d, idx = torch.topk(dist, k, dim=1, largest=False, sorted=True)
    gap = (d - d[:, :1]) / torch.clamp(d[:, :1], min=1e-300)
    nxt = torch.stack([step(dic, num, x, u, idx[:, j]) for j in range(k)],
                      dim=1)
    return nxt, gap
