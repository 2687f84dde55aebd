"""Rules of the PyTorch port that hold for every file: it imports neither
JAX nor the JAX package, and its entry points refuse to run on a card that
is not there."""

import ast
import os

import numpy as np
import pytest
import torch

from torch_helpers import CAMPAIGN, REPO

FORBIDDEN = {"jax", "jaxlib", "soft_robot_control_tpu"}


def _port_files():
    """The package, chip_smoke.py, cluster_probe.py, and the card tests
    with their helpers, which run on a machine without JAX."""
    root = os.path.join(REPO, "soft_robot_control_tpu_torch")
    files = [os.path.join(REPO, p) for p in (
        "chip_smoke.py", "cluster_probe.py",
        "tests/test_torch_kernels_cuda.py", "tests/torch_helpers.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    """First dotted component of every module an import statement names."""
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 24
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"soft_robot_control_tpu_torch/scp/locp.py",
            "soft_robot_control_tpu_torch/ops/admm_single.py",
            "soft_robot_control_tpu_torch/scp/gusto.py",
            "soft_robot_control_tpu_torch/scp/gusto_jit.py",
            "soft_robot_control_tpu_torch/control/service.py",
            "soft_robot_control_tpu_torch/control/linear_mpc.py",
            "soft_robot_control_tpu_torch/models/linear.py",
            "soft_robot_control_tpu_torch/models/dubins.py",
            "soft_robot_control_tpu_torch/models/interfaces.py",
            "soft_robot_control_tpu_torch/core/types.py"} <= names
    bad = {os.path.relpath(f, REPO): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files}
    assert not {f: r for f, r in bad.items() if r}
    # the check compares whole names: the port's own package is allowed
    assert "soft_robot_control_tpu_torch" in _imported_roots(
        os.path.join(REPO, "chip_smoke.py"))


def _entry_points():
    from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
    from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
    from soft_robot_control_tpu_torch.rom.pod import POD
    from soft_robot_control_tpu_torch.scp.locp import LOCP, LOCPSpec
    from soft_robot_control_tpu_torch.control.linear_mpc import (
        LinearMPCService)
    from soft_robot_control_tpu_torch.core.types import QuadraticCost, Target
    from soft_robot_control_tpu_torch.models.dubins import DubinsCar
    from soft_robot_control_tpu_torch.models.linear import (
        LinearROM, tpwl_to_linear_rom)
    from soft_robot_control_tpu_torch.scp.locp_condensed import (
        CondensedLOCPAdapter, CondensedSpec)
    from soft_robot_control_tpu_torch.tasks.demo import make_demo_tpwl

    rom = {"U": np.eye(4, 2), "q_ref": np.zeros(4), "v_ref": np.zeros(4)}

    class LTI:  # numpy arrays: no device of its own
        A_d, B_d, d_d, H = np.eye(2), np.ones((2, 1)), np.zeros(2), np.eye(2)

    return {
        "from_tpwl_dict": lambda: from_tpwl_dict(CAMPAIGN),
        "POD": lambda: POD(rom),
        "CondensedSpec": lambda: CondensedSpec(2, np.eye(1), np.eye(1),
                                               np.eye(1)),
        "LOCPSpec": lambda: LOCPSpec(2, np.eye(1), np.eye(1), np.eye(1)),
        "LOCP": lambda: LOCP(2, np.eye(1), np.eye(1), np.eye(1)),
        "BatchMPC": lambda: BatchMPC(from_tpwl_dict(CAMPAIGN, device="cpu"),
                                     np.eye(1), np.eye(4), N=2, dt=0.01,
                                     formulation="condensed"),
        "BatchMPC_sparse": lambda: BatchMPC(
            from_tpwl_dict(CAMPAIGN, device="cpu"), np.eye(1), np.eye(4),
            N=2, dt=0.01),
        "CondensedSpec_trust_region": lambda: CondensedSpec(
            2, np.eye(1), np.eye(1), np.eye(1), trust_region=True),
        "CondensedLOCPAdapter": lambda: CondensedLOCPAdapter(
            2, np.eye(1), np.eye(1), np.eye(1)),
        "DubinsCar": lambda: DubinsCar(),
        "make_demo_tpwl": lambda: make_demo_tpwl(r=2, P=3, nf=4),
        "LinearROM": lambda: LinearROM(tpwl_to_linear_rom(CAMPAIGN), 0.01),
        "LinearMPCService": lambda: LinearMPCService(
            LTI(), 2, 0.1, QuadraticCost(np.eye(2), np.eye(1)),
            Target(z=np.zeros(2)), locp_backend="condensed"),
    }


@pytest.mark.parametrize("name", ["from_tpwl_dict", "POD", "CondensedSpec",
                                  "LOCPSpec", "LOCP", "BatchMPC",
                                  "BatchMPC_sparse",
                                  "CondensedSpec_trust_region",
                                  "CondensedLOCPAdapter", "DubinsCar",
                                  "make_demo_tpwl", "LinearROM",
                                  "LinearMPCService"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
