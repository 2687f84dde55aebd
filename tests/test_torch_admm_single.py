"""Kernel 4 of the port, the single-QP fixed-iteration ADMM with the
x-step applied as M1' (M1 rhs): `admm_fixed_single` through its plain
version against the JAX package's `admm_fixed_pallas` (Pallas kernel in
interpret mode, which rounds to f32) and, tightly, against `admm_fixed`, on
the QP of tests/test_pallas.py. The CUDA kernel is held to the plain version in
tests/test_torch_kernels_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.control.batch_mpc import admm_fixed as jax_fixed
from soft_robot_control_tpu.ops.pallas_admm import admm_fixed_pallas
from soft_robot_control_tpu_torch.control.batch_mpc import admm_fixed
from soft_robot_control_tpu_torch.ops.admm_single import (admm_fixed_single,
                                                          admm_single,
                                                          prepare_single)


def _qp(seed, n=30, m=40):
    """tests/test_pallas.py's QP: equality rows with a boosted rho and
    one-sided rows with an infinite lower bound."""
    rng = np.random.default_rng(seed)
    Ph = rng.normal(size=(n, n))
    P = Ph @ Ph.T + 0.1 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    xf = rng.normal(size=n) * 0.2
    l = A @ xf - rng.uniform(0.1, 1, m)
    u = A @ xf + rng.uniform(0.1, 1, m)
    l[:5] = u[:5]
    l[5:8] = -np.inf
    rho = 0.1 * np.ones(m)
    rho[:5] *= 1000
    return P, q, A, l, u, np.zeros(n), np.zeros(m), rho


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_single_matches_pallas(seed):
    """Against the Pallas kernel at tests/test_pallas.py's 2e-5 on w (1e-4
    on y), not tighter: that kernel's dots carry
    preferred_element_type=float32, so even its f64 run rounds every
    mat-vec to f32. Measured here: 4.2e-6 on w, 4.8e-5 on y."""
    qp = _qp(seed)
    w1, y1 = admm_fixed_pallas(*[jnp.asarray(a) for a in qp], 200,
                               interpret=True)
    launches = admm_single.launches
    w2, y2 = admm_fixed_single(*[torch.as_tensor(a) for a in qp], 200)
    assert admm_single.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(w2.numpy(), np.asarray(w1), atol=2e-5)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y1), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_single_matches_the_cholesky_solver(seed):
    """K^-1 = M1' M1 exactly, so in f64 the M1 iteration equals the
    Cholesky-solve iteration of `admm_fixed`, the JAX package's and the
    port's: 1e-9 on (w, y) (measured 3e-14 and 2e-13)."""
    qp = _qp(seed)
    w, y = admm_fixed_single(*[torch.as_tensor(a) for a in qp], 200)
    wj, yj = jax_fixed(*[jnp.asarray(a) for a in qp], 200)
    wt, yt = admm_fixed(*[torch.as_tensor(a)[None] for a in qp[:7]],
                        torch.as_tensor(qp[7]), 200)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=1e-9)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-9)
    np.testing.assert_allclose(w.numpy(), wt[0].numpy(), atol=1e-9)
    np.testing.assert_allclose(y.numpy(), yt[0].numpy(), atol=1e-9)


def test_prepare_single_factors_the_inverse():
    P, q, A, l, u, _, _, rho = (torch.as_tensor(a) for a in _qp(2))
    M1, l_f, u_f = prepare_single(P, A, l, u, rho)
    K = P + 1e-6 * torch.eye(30, dtype=P.dtype) + (A.T * rho) @ A
    np.testing.assert_allclose((M1.T @ M1 @ K).numpy(), np.eye(30),
                               atol=1e-9)
    assert torch.equal(l_f[5:8], torch.full((3,), -1e30, dtype=P.dtype))
    assert torch.equal(l_f[8:], l[8:]) and torch.equal(u_f, u)


def test_wrapper_rejects_other_devices():
    args = [torch.as_tensor(a).to("meta") for a in _qp(0)]
    with pytest.raises(ValueError, match="unsupported device"):
        admm_single(*args, 5)
