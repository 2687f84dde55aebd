"""The port's CUDA kernels on the card, against their plain versions.

These tests import neither JAX nor the JAX package, so that they run on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

(`--noconftest` skips tests/conftest.py, which configures JAX). Without a
card every test here skips.
"""

import numpy as np
import pytest
import torch

from torch_helpers import (CAMPAIGN_PARAMS, campaign_dict,  # noqa: F401
                           campaign_output_maps, cuda_device)

from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
from soft_robot_control_tpu_torch.ops.admm_batched import (admm_batched,
                                                           admm_batched_plain)
from soft_robot_control_tpu_torch.ops.tpwl_select import (
    point_distances_batch, tpwl_select, tpwl_select_plain)
from soft_robot_control_tpu_torch.qp.blocked import make_kinv

pytestmark = pytest.mark.cuda


def _qps(B, n, m, seed):
    """Random feasible QPs with K^-1 from the port's make_kinv (f64)."""
    rng = np.random.default_rng(seed)
    Ph = rng.normal(size=(B, n, n))
    P = torch.as_tensor(Ph @ Ph.transpose(0, 2, 1) + 0.1 * np.eye(n))
    A = rng.normal(size=(B, m, n))
    mid = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.2)
    rho = torch.full((m,), 0.1, dtype=torch.float64)
    A = torch.as_tensor(A)
    Kinv = make_kinv(P, A, rho)
    return [Kinv, A, torch.as_tensor(rng.normal(size=(B, n))),
            torch.as_tensor(mid - rng.uniform(0.1, 1, (B, m))),
            torch.as_tensor(mid + rng.uniform(0.1, 1, (B, m))), rho,
            torch.as_tensor(0.1 * rng.normal(size=(B, n))),
            torch.as_tensor(0.1 * rng.normal(size=(B, m)))]


@pytest.mark.parametrize("B", [1, 3, 1024])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
def test_admm_kernel_matches_plain(cuda_device, B, dtype, tol):
    args = [t.to(cuda_device, dtype) for t in _qps(B, 20, 40, seed=B)]
    launches = admm_batched.launches
    w1, y1 = admm_batched(*args, 25)
    w2, y2 = admm_batched_plain(*args, 25)
    torch.cuda.synchronize()
    assert admm_batched.launches == launches + 1
    for got, ref in ((w1, w2), (y1, y2)):
        scale = 1.0 if dtype == torch.float64 else max(
            float(ref.abs().max()), 1.0)
        assert float((got - ref).abs().max()) <= tol * scale


def test_admm_kernel_refuses_what_does_not_fit(cuda_device):
    args = [t.to(cuda_device) for t in _qps(1, 200, 400, seed=0)]
    with pytest.raises(ValueError, match="shared memory"):
        admm_batched(*args, 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_select_kernel_matches_plain(cuda_device, dtype):
    """On the full campaign dictionary (P=1087): identical indices except
    at near-ties, and bitwise-equal rows wherever the indices agree."""
    model = from_tpwl_dict(campaign_dict(), params=CAMPAIGN_PARAMS,
                           device=cuda_device)
    rng = np.random.default_rng(5)
    X = torch.cat([model.v, model.q], dim=1)
    pts = torch.as_tensor(rng.integers(0, model.num_points, 2000),
                          device=cuda_device)
    noise = torch.as_tensor(rng.normal(size=(2000, 60)), device=cuda_device)
    x = X[pts] + 0.05 * X.std(dim=0) * noise
    d = point_distances_batch(x, model.q, model.v, 10.0, 1.0)
    two = torch.topk(d, 2, dim=1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) < 1e-6 * two[:, 0]
    m = model.to(dtype=dtype)
    dic = (m.q, m.v, m.A_d, m.B_d, m.d_d, 10.0, 1.0)
    got = tpwl_select(x.to(dtype), *dic)
    ref = tpwl_select_plain(x.to(dtype), *dic)
    torch.cuda.synchronize()
    same = got[0] == ref[0]
    assert bool((same | near_tie).all())
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a[same], b[same])


def test_closed_loop_on_the_card_matches_the_cpu(cuda_device):
    """BatchMPC on a 64-point campaign subset: the card's f32 loop goes
    through both kernels and agrees with the f64 CPU loop."""
    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    Cf, Hf = campaign_output_maps()
    B, n_win = 16, 3
    logs, counts = {}, {}
    for dev, dt in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        model = from_tpwl_dict(data, params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf,
                               device=dev)
        mpc = BatchMPC(model, 100.0 * np.eye(3), 1e-5 * np.eye(4), N=5,
                       dt=0.01, N_replan=2, qp_iters=100, rho_stages=4,
                       U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
                       W=1e-2 * np.eye(60), V=1e-4 * np.eye(30), dtype=dt,
                       device=dev)
        z_ref = model.z_ref.cpu().numpy()
        t = 0.01 * np.arange(n_win * 2 + 6)
        zt = z_ref + 2.0 * np.sin(2 * np.pi * t[:, None] / 0.5)
        zt = np.stack([np.stack([zt[2 * w:2 * w + 6] for w in range(n_win)])]
                      * B)
        admm_batched.launches = tpwl_select.launches = 0
        out = mpc.build_fused(n_win)(np.zeros((B, 60)), np.zeros((B, 60)),
                                     zt)
        counts[str(dev)] = (admm_batched.launches, tpwl_select.launches)
        logs[str(dev)] = out["z"].double().cpu().numpy()
    assert counts[str(cuda_device)] == (4 * n_win, 3 * n_win)
    assert counts["cpu"] == (0, 0)
    ref = logs["cpu"]
    diff = np.linalg.norm(logs[str(cuda_device)] - ref)
    assert diff <= 1e-4 * np.linalg.norm(ref - ref.mean(axis=(0, 1)))
