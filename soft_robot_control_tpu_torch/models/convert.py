"""Carry a TPWL or SSM model across from the JAX package.

The JAX TPWLModel is a pytree whose children (`TPWLModel._children`) are
arrays and whose static fields are discr_method, tpwl_method and
pre_discretized_dt. A caller that holds such a model flattens it into a
dict of numpy arrays, with the POD basis as the dict {"U", "q_ref",
"v_ref"} under "rom" (the JAX POD's `get_info()`), and hands that dict to
`model_from_arrays`. An SSMModel goes the same way through
`ssm_model_arrays` and `ssm_model_from_arrays`, a KoopmanModel through
`koopman_model_arrays` and `koopman_model_from_dict`, a FEMSurrogate plant
through `surrogate_arrays` and `surrogate_from_arrays`, a TetFEM plant
through `tet_fem_arrays` and `tet_fem_from_arrays`. `flatten_arrays`
and `unflatten_arrays` carry such nested dicts through an `.npz` file.
This module itself imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.models.koopman import (KoopmanModel,
                                                         KoopmanScaling,
                                                         ScaleRows)
from soft_robot_control_tpu_torch.models.ssm import SSMModel
from soft_robot_control_tpu_torch.models.tpwl import TPWLModel
from soft_robot_control_tpu_torch.rom.pod import POD
from soft_robot_control_tpu_torch.sim.fem_surrogate import FEMSurrogate
from soft_robot_control_tpu_torch.sim.fem_tet import (LEAVES, TetFEM,
                                                      _leaf_arrays)

_ARRAYS = ("q", "v", "u", "A_c", "B_c", "d_c", "A_d", "B_d", "d_d", "C",
           "y_ref", "H", "z_ref")


def _np(a):
    if a is None:
        return None
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def model_arrays(model) -> dict:
    """The dict `model_from_arrays` takes, from any object with the
    TPWLModel attributes (the JAX model or this package's)."""
    out = {k: _np(getattr(model, k)) for k in _ARRAYS}
    out["rom"] = {k: _np(getattr(model.rom, k))
                  for k in ("U", "q_ref", "v_ref")}
    out["dist_w_q"] = float(_np(model.dist_w_q))
    out["dist_w_v"] = float(_np(model.dist_w_v))
    out["beta"] = None if model.beta is None else float(_np(model.beta))
    for k in ("discr_method", "tpwl_method", "pre_discretized_dt"):
        out[k] = getattr(model, k)
    return out


def model_from_arrays(arrays: dict, device="cuda") -> TPWLModel:
    """This package's TPWLModel from the arrays and static fields of a
    TPWL model (see `model_arrays`), with every array on `device`."""
    rom = POD(arrays["rom"], device=device)
    kw = {k: arrays.get(k) for k in _ARRAYS}
    return TPWLModel(rom=rom, dist_w_q=arrays["dist_w_q"],
                     dist_w_v=arrays["dist_w_v"], beta=arrays.get("beta"),
                     discr_method=arrays["discr_method"],
                     tpwl_method=arrays["tpwl_method"],
                     pre_discretized_dt=arrays.get("pre_discretized_dt"),
                     device=device, **kw)


_SSM_STATIC = ("state_dim", "input_dim", "output_dim", "SSM_order",
               "ROM_order", "Ts", "discrete", "discr_method")


def ssm_model_arrays(model) -> dict:
    """The dict `ssm_model_from_arrays` takes, from any object with the
    SSMModel attributes (the JAX model or this package's): its coefficient
    arrays as numpy arrays and its static fields."""
    out = {k: _np(getattr(model, k)) for k in SSMModel._children}
    out.update({k: getattr(model, k) for k in _SSM_STATIC})
    return out


def ssm_model_from_arrays(arrays: dict, dtype=torch.float64,
                          device="cuda") -> SSMModel:
    """This package's SSMModel from the arrays and static fields of an SSM
    model (see `ssm_model_arrays`), in `dtype` on `device`."""
    return SSMModel(**{k: arrays[k] for k in SSMModel._children + _SSM_STATIC},
                    dtype=dtype, device=device)


_KOOPMAN_STATIC = ("n", "m", "state_dim", "delays", "obs_degree", "obs_type",
                   "Ts", "DMD")


def koopman_model_arrays(model) -> dict:
    """The dict `koopman_model_from_dict` takes, from any object with the
    KoopmanModel attributes (the JAX model or this package's): A_d, B_d,
    C, V, W as numpy arrays, the scaling as the dict of its four rows, and
    the static fields."""
    out = {k: _np(getattr(model, k)) for k in ("A_d", "B_d", "C", "V", "W")}
    sc = KoopmanScaling(model.scale)
    out["scale"] = {k: np.asarray(getattr(sc, k)).reshape(-1) for k in (
        "y_offset", "y_factor", "u_offset", "u_factor")}
    out.update({k: getattr(model, k) for k in _KOOPMAN_STATIC})
    return out


def koopman_model_from_dict(arrays: dict, dtype=torch.float64,
                            device="cuda") -> KoopmanModel:
    """This package's KoopmanModel from the arrays and static fields of a
    Koopman model (see `koopman_model_arrays`), in `dtype` on `device`."""
    obj = KoopmanModel.__new__(KoopmanModel)
    a = arrays
    obj._setup(a["A_d"], a["B_d"], a["C"], a["V"], a["W"], n=a["n"],
               m=a["m"], nzeta=a["state_dim"], delays=a["delays"],
               obs_degree=a["obs_degree"], obs_type=a["obs_type"],
               Ts=a["Ts"], scale=ScaleRows(a["scale"]), dmd=a["DMD"],
               dtype=dtype, device=device)
    return obj


_SURROGATE = ("K", "m_node", "alpha", "beta", "gamma", "q_rest", "H")


def surrogate_arrays(plant) -> dict:
    """The dict `surrogate_from_arrays` takes, from any object with the
    FEMSurrogate attributes (the JAX plant or this package's): K, q_rest
    and H as numpy arrays, the four coefficients as floats."""
    out = {k: _np(getattr(plant, k)) for k in _SURROGATE}
    for k in ("m_node", "alpha", "beta", "gamma"):
        out[k] = float(out[k])
    return out


def surrogate_from_arrays(arrays: dict, device="cuda") -> FEMSurrogate:
    """This package's FEMSurrogate from a plant's arrays (see
    `surrogate_arrays`), on `device`."""
    return FEMSurrogate(*(arrays[k] for k in _SURROGATE), device=device)


_TET_STATIC = ("dt", "cg_iters", "cg_tol")


def tet_fem_arrays(plant) -> dict:
    """The dict `tet_fem_from_arrays` takes, from any object with the
    TetFEM attributes (the JAX plant or this package's): its 15 leaves as
    numpy arrays (`fem_tet._leaf_arrays`, the plant cache's) and dt,
    cg_iters, cg_tol."""
    out = _leaf_arrays(plant)
    out.update({k: getattr(plant, k) for k in _TET_STATIC})
    return out


def tet_fem_from_arrays(arrays: dict, device="cuda") -> TetFEM:
    """This package's TetFEM from a plant's leaves and static fields (see
    `tet_fem_arrays`), in the leaves' dtype on `device`."""
    return TetFEM(*(arrays[k] for k in LEAVES + _TET_STATIC), device=device)


def flatten_arrays(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays, numbers and strings as one flat dict with
    "/"-joined keys, which `np.savez` stores without pickling; None values
    are left out."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten_arrays(v, f"{prefix}{k}/"))
        elif v is not None:
            flat[prefix + k] = np.asarray(v)
    return flat


def unflatten_arrays(flat) -> dict:
    """The nested dict of `flatten_arrays`' output (or of the `np.load` of
    its `.npz`): 0-d arrays back to Python numbers and strings."""
    tree = {}
    for key in flat:
        v = np.asarray(flat[key])
        if v.ndim == 0:
            v = v.item()
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
