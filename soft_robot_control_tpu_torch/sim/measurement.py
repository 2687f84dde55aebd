"""Node-selection measurement matrices y = C x over the packed full state
x = [v(3n); q(3n)] (3 DoF per node), as the reference builds them
(measurement_models.py:7-44)."""

from __future__ import annotations

import numpy as np


def _selection_rows(nodes, num_nodes, pos: bool, vel: bool):
    """Column indices of the selected components, ordered [v-block;
    q-block]."""
    nodes = list(nodes)
    cols = []
    if vel:
        for node in nodes:
            cols += [3 * node, 3 * node + 1, 3 * node + 2]
    if pos:
        for node in nodes:
            cols += [3 * num_nodes + 3 * node, 3 * num_nodes + 3 * node + 1,
                     3 * num_nodes + 3 * node + 2]
    return np.asarray(cols, dtype=np.int64)


class linearModel:
    """y = C x on a node subset; `C_dense` materializes C as float64."""

    def __init__(self, nodes, num_nodes, pos=True, vel=True):
        self.cols = _selection_rows(nodes, num_nodes, pos, vel)
        self.n_full = 6 * num_nodes

    def C_dense(self):
        C = np.zeros((len(self.cols), self.n_full))
        C[np.arange(len(self.cols)), self.cols] = 1.0
        return C
