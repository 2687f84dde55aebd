"""Online control policies: for now the row interpolation that the ROMPC
and Koopman controllers share. The policies themselves (the template
controller, iLQR, trajectory tracking, the LQR and open-loop policies) are
not ported yet."""

from __future__ import annotations

import numpy as np


def _interp_rows(tq, t, Y):
    """np.interp of every column of Y (K, C) from the knots t (K,) at the
    points tq (Q,): (Q, C), constant beyond the ends."""
    t = np.asarray(t, float)
    Y = np.asarray(Y, float)
    return np.stack([np.interp(tq, t, Y[:, j]) for j in range(Y.shape[1])],
                    axis=1)
