"""Shared fixtures of the PyTorch-port parity tests.

The port runs on the CPU here through its kernels' plain versions, in f64,
single-threaded: the JAX runtime's own thread pool works in the same
process, and two pools spinning on the same cores slow both by orders of
magnitude. Inputs are made with numpy and handed to both packages.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGN = os.path.join(REPO, "examples", "diamond_tet",
                        "tpwl_model_snapshots.pkl")
CAMPAIGN_PARAMS = {"dist_weights": {"q": 10.0, "v": 1.0}}
DICT_KEYS = ("q", "v", "u", "A_c", "B_c", "d_c", "A_d", "B_d", "d_d")


def campaign_output_maps():
    """Cf (y: 5 nodes, pos + vel) and Hf (z: one node's position) of the
    Diamond campaign, as bench.py builds them."""
    from soft_robot_control_tpu_torch.sim.measurement import linearModel

    Cf = linearModel([1354, 726, 139, 1445, 729], 1628).C_dense()
    Hf = linearModel([1354], 1628, vel=False).C_dense()
    return Cf, Hf


def campaign_dict(points=None):
    """The committed Diamond campaign TPWL dictionary in float64, or the
    subset of it at the indices `points`."""
    from soft_robot_control_tpu_torch.utils.io import load_data

    data = load_data(CAMPAIGN)
    sel = slice(None) if points is None else np.asarray(points)
    return {k: (np.asarray(v)[sel].astype(np.float64) if k in DICT_KEYS
                else v) for k, v in data.items()}


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")
