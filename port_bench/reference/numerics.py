"""The precision the reference computes in.

`Numerics(torch.float64)` is the reference. `Numerics(torch.float32,
tf32=True)` is the control of the correctness check: float32 with every
matrix product's operands rounded to TF32 (10 explicit mantissa bits, the
tensor cores' input format), the step below the program's stated float32
with TF32 off. The rounding is done here, not left to
`torch.backends.cuda.matmul.allow_tf32`, so that the control is the same on
any device and for products that cuBLAS would not send to the tensor cores.
"""

from __future__ import annotations

import numpy as np
import torch

_TF32_DROP = 13          # float32 keeps 23 mantissa bits, TF32 keeps 10
_TF32_MASK = ~((1 << _TF32_DROP) - 1)


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` rounded to TF32, to nearest with ties to even."""
    i = a.contiguous().view(torch.int32)
    odd = (i >> _TF32_DROP) & 1
    r = (i + ((1 << (_TF32_DROP - 1)) - 1) + odd) & _TF32_MASK
    # keep inf and nan as they are
    keep = ~torch.isfinite(a)
    return torch.where(keep, a, r.view(torch.float32))


class Numerics:
    """dtype of every tensor of the reference, and whether its matrix
    products take TF32 operands."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 operands need float32")
        self.dtype = dtype
        self.tf32 = bool(tf32)

    @property
    def name(self) -> str:
        return "tf32" if self.tf32 else str(self.dtype).replace("torch.", "")

    def t(self, a, device=None) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(device=device if device is not None else a.device,
                        dtype=self.dtype)
        return torch.as_tensor(np.array(a), dtype=self.dtype, device=device)

    def _op(self, a):
        return round_tf32(a) if self.tf32 else a

    def mm(self, a, b):
        """a @ b."""
        return self._op(a) @ self._op(b)

    def mv(self, M, v):
        """M (..., i, j) times v (..., j)."""
        return (self._op(M) @ self._op(v)[..., None])[..., 0]

    def einsum(self, eq, *ops):
        return torch.einsum(eq, *(self._op(a) for a in ops))


def control_numerics(dtype) -> Numerics:
    """The control's precision: the step below a configuration's `dtype`
    (float32 with TF32 off -> TF32 operands; float64 -> float32)."""
    if dtype == torch.float32:
        return Numerics(torch.float32, tf32=True)
    if dtype == torch.float64:
        return Numerics(torch.float32)
    raise ValueError(f"no control precision below {dtype}")
