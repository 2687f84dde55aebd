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
            "soft_robot_control_tpu_torch/ops/admm_single.py"} <= names
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
    from soft_robot_control_tpu_torch.scp.locp_condensed import CondensedSpec

    rom = {"U": np.eye(4, 2), "q_ref": np.zeros(4), "v_ref": np.zeros(4)}
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
    }


@pytest.mark.parametrize("name", ["from_tpwl_dict", "POD", "CondensedSpec",
                                  "LOCPSpec", "LOCP", "BatchMPC",
                                  "BatchMPC_sparse"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
