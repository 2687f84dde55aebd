"""Artifact IO: the pickle format of the reference TPWL/POD artifacts
(sofacontrol/utils.py:148-159), as the JAX package's utils/io.py reads it.
Unpickling runs code, so only load artifacts this project wrote."""

from __future__ import annotations

import pickle
from typing import Any


def load_data(filename: str) -> Any:
    with open(filename, "rb") as f:
        return pickle.load(f)
