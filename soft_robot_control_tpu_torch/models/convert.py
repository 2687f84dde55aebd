"""Carry a TPWL model across from the JAX package.

The JAX TPWLModel is a pytree whose children (`TPWLModel._children`) are
arrays and whose static fields are discr_method, tpwl_method and
pre_discretized_dt. A caller that holds such a model flattens it into a
dict of numpy arrays, with the POD basis as the dict {"U", "q_ref",
"v_ref"} under "rom" (the JAX POD's `get_info()`), and hands that dict to
`model_from_arrays`. This module itself imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.models.tpwl import TPWLModel
from soft_robot_control_tpu_torch.rom.pod import POD

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
                     pre_discretized_dt=arrays["pre_discretized_dt"],
                     device=device, **kw)
