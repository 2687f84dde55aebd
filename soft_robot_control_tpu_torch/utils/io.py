"""Artifact IO: the pickle format of the reference TPWL/POD artifacts
(sofacontrol/utils.py:148-159), as the JAX package's utils/io.py reads and
writes it. Unpickling runs code, so only load artifacts this project wrote."""

from __future__ import annotations

import os
import pickle
from typing import Any


def save_data(filename: str, data: Any) -> None:
    d = os.path.dirname(filename)
    if d and not os.path.isdir(d):
        os.makedirs(d, exist_ok=True)
    with open(filename, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_data(filename: str) -> Any:
    with open(filename, "rb") as f:
        return pickle.load(f)
