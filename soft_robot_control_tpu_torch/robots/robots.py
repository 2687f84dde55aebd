"""Robot definitions: actuation metadata, the surrogate plant and the
excitation-sequence factory (robots/environments.py and
examples/hardware/model.py of the reference; the JAX package's
robots/robots.py).

Each robot bundles the in-repo FEM surrogate plant (`make_chain_robot`, on
`device` in `dtype`), its actuation limits, default measurement and output
nodes, its time step and its sequences:
- Diamond: 4 cables, u in [0, 1500] mN (examples/hardware/model.py:25;
  the reference mesh has 1628 nodes, a 9768-dim state);
- Trunk: 8 cables, u in [0, 800] (robots/environments.py:44);
- Finger: 1 cable, u in [0, 2000] (open_loop_sequences.py:244-250).
The robots on the tet-FEM meshes (TetMeshRobot, DiamondTetRobot,
TrunkTetRobot) carry `sim/fem_tet.py`'s plant, built from the reference's
mesh or from the mesh file at `mesh_path`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.control import sequences as seqs
from soft_robot_control_tpu_torch.sim.fem_surrogate import make_chain_robot


class SurrogateRobot:
    """Base robot: surrogate plant + metadata + sequence factory."""

    name = "surrogate"
    n_cables = 4
    u_min = 0.0
    u_max = 1.0
    dt = 0.01
    n_nodes = 12

    def __init__(self, n_nodes: Optional[int] = None, seed: int = 0,
                 device="cuda", dtype=torch.float64, **plant_kwargs):
        self.nb_nodes = n_nodes or self.n_nodes
        self.plant = self._make_plant(self.nb_nodes, seed, device=device,
                                      dtype=dtype, **plant_kwargs)
        self.sequences = self._make_sequences()

    def _plant_defaults(self, n_nodes) -> dict:
        return {}

    def _make_plant(self, n_nodes, seed, device, dtype, **kw):
        args = {**self._plant_defaults(n_nodes), **kw}
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype.type
        return make_chain_robot(n_nodes=n_nodes, n_cables=self.n_cables,
                                seed=seed, dtype=np_dtype, device=device,
                                **args)

    def _make_sequences(self):
        s = seqs.BaseRobotSequences(
            self.n_cables, u0=np.zeros(self.n_cables),
            umax=self.u_max * np.ones(self.n_cables),
            umin=self.u_min * np.ones(self.n_cables), dt=self.dt, t0=1.0)
        s.active_inputs = [True] * self.n_cables
        return s

    # measurement / output models over the surrogate's DoF (one a node;
    # the reference has 3 a mesh node), numpy on the host ----------------
    @property
    def default_output_nodes(self):
        return [self.nb_nodes - 1]

    @property
    def default_measurement_nodes(self):
        n = self.nb_nodes
        return [n // 3, 2 * n // 3, n - 1]

    def get_measurement_model(self, nodes=None, noise_q=0.0, noise_v=0.0):
        nodes = nodes if nodes is not None else self.default_measurement_nodes
        n = self.nb_nodes
        rows = []
        for node in nodes:
            rows.append(("v", node))
        for node in nodes:
            rows.append(("q", node))
        C = np.zeros((len(rows), 2 * n))
        for i, (kind, node) in enumerate(rows):
            C[i, node if kind == "v" else n + node] = 1.0
        return C

    def get_output_model(self, nodes=None):
        nodes = nodes if nodes is not None else self.default_output_nodes
        n = self.nb_nodes
        H = np.zeros((len(nodes), 2 * n))
        for i, node in enumerate(nodes):
            H[i, n + node] = 1.0
        return H


class DiamondRobot(SurrogateRobot):
    """Hardware-calibrated Diamond analog (examples/hardware/model.py:28-45)."""

    name = "diamond"
    n_cables = 4
    u_min = 0.0
    u_max = 1500.0
    dt = 0.01
    n_nodes = 12

    def _plant_defaults(self, n_nodes):
        # stiffness scaled so u_max-scale forces give O(1) deflections
        return dict(k=40.0 * 500.0, m_node=0.45 / n_nodes, alpha=2.5,
                    beta=0.01, gamma=25.0 * 500.0)

    def _make_sequences(self):
        return seqs.DiamondRobotSequences(dt=self.dt, t0=1.0)


class TrunkRobot(SurrogateRobot):
    """Trunk analog: 8 cables, u in [0, 800] (robots/environments.py:39-137)."""

    name = "trunk"
    n_cables = 8
    u_min = 0.0
    u_max = 800.0
    dt = 0.01
    n_nodes = 10

    def _plant_defaults(self, n_nodes):
        return dict(k=40.0 * 300.0, m_node=0.42 / n_nodes, alpha=1.5,
                    beta=0.01, gamma=25.0 * 300.0)

    def _make_sequences(self):
        return seqs.TrunkRobotSequences(dt=self.dt, t0=1.0)


class FingerRobot(SurrogateRobot):
    """Finger: 1 cable, u in [0, 2000] (open_loop_sequences.py:244-250;
    the reference has sequences and a mesh but no environment class)."""

    name = "finger"
    n_cables = 1
    u_min = 0.0
    u_max = 2000.0
    dt = 0.01
    n_nodes = 8

    def _plant_defaults(self, n_nodes):
        return dict(k=40.0 * 600.0, m_node=0.2 / n_nodes, alpha=1.5,
                    beta=0.01, gamma=25.0 * 600.0)

    def _make_sequences(self):
        return seqs.FingerRobotSequences(dt=self.dt, t0=1.0)


# ---------------------------------------------------------------------------
# Reference-mesh tet-FEM robots (full scale)


class TetMeshRobot:
    """Robot over the tet-FEM plant built from the reference's shipped mesh
    (or a mesh file at `mesh_path`): full reference dimensions (Diamond
    1628 nodes -> 9768-dim state, Trunk 709 -> 4254). Measurement and
    output models follow the reference node conventions with 3 DoF a node
    (sofacontrol/measurement_models.py). The plant keyword arguments
    (device, dtype, mesh_path, cache, gravity_on, ...) go to the plant's
    builder; the plant lies on `device` ("cuda" by default)."""

    name = "tetmesh"
    n_cables = 4
    u_min = 0.0
    u_max = 1.0
    dt = 0.01
    default_output_nodes = [0]
    default_measurement_nodes = [0]

    def __init__(self, dt: float = None, **plant_kwargs):
        if dt is not None:
            self.dt = dt
        self.plant = self._make_plant(dt=self.dt, **plant_kwargs)
        self.nb_nodes = self.plant.n_nodes
        self.sequences = self._make_sequences()

    def _make_plant(self, **kw):
        raise NotImplementedError

    def _make_sequences(self):
        s = seqs.BaseRobotSequences(
            self.n_cables, u0=np.zeros(self.n_cables),
            umax=self.u_max * np.ones(self.n_cables),
            umin=self.u_min * np.ones(self.n_cables), dt=self.dt, t0=1.0)
        s.active_inputs = [True] * self.n_cables
        return s

    def get_measurement_model(self, nodes=None, pos=True, vel=True):
        from soft_robot_control_tpu_torch.sim.measurement import linearModel
        nodes = nodes if nodes is not None else self.default_measurement_nodes
        return linearModel(nodes, self.nb_nodes, pos=pos, vel=vel).C_dense()

    def get_output_model(self, nodes=None, pos=True, vel=False):
        """Position outputs of the end-effector node by default (the
        reference tracks node positions; velocities excluded unless asked,
        examples/diamond/diamond.py:167,222)."""
        from soft_robot_control_tpu_torch.sim.measurement import linearModel
        nodes = nodes if nodes is not None else self.default_output_nodes
        return linearModel(nodes, self.nb_nodes, pos=pos, vel=vel).C_dense()


class DiamondTetRobot(TetMeshRobot):
    """Hardware-calibrated Diamond on the shipped diamond.vtu
    (examples/hardware/model.py:28-45; robots/environments.py:139-238).
    End effector node 1354, elbows [726, 139, 1445, 729]
    (examples/diamond/diamond.py:14-15)."""

    name = "diamond_tet"
    n_cables = 4
    u_min = 0.0
    u_max = 1500.0
    dt = 0.01
    default_output_nodes = [1354]
    default_measurement_nodes = [1354, 726, 139, 1445, 729]

    def _make_plant(self, **kw):
        from soft_robot_control_tpu_torch.sim.fem_tet import diamond_tet_fem
        return diamond_tet_fem(**kw)

    def _make_sequences(self):
        return seqs.DiamondRobotSequences(dt=self.dt, t0=1.0)


class TrunkTetRobot(TetMeshRobot):
    """Trunk on the shipped trunk.vtk (robots/environments.py:39-137).
    Tip node 51, defaults [51, 22, 37] (examples/trunk/trunk.py:15)."""

    name = "trunk_tet"
    n_cables = 8
    u_min = 0.0
    u_max = 800.0
    dt = 0.01
    default_output_nodes = [51]
    default_measurement_nodes = [51, 22, 37]

    def _make_plant(self, **kw):
        from soft_robot_control_tpu_torch.sim.fem_tet import trunk_tet_fem
        return trunk_tet_fem(**kw)

    def _make_sequences(self):
        return seqs.TrunkRobotSequences(dt=self.dt, t0=1.0)
