"""Kernels 1 and 3 of the port, the batched fixed-iteration ADMM for QPs
that fit a block's shared memory, a cluster's, or neither: their one plain
version against the JAX package's Pallas kernels (interpret mode), the
chunked one and the per-QP grid. The CUDA kernels are held to the plain version in
tests/test_torch_kernels_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.control.batch_mpc import make_kinv as jax_make_kinv
from soft_robot_control_tpu.ops.pallas_admm import (
    _admm_batched_pallas_grid, _pick_chunk, admm_batched_pallas)
from soft_robot_control_tpu_torch.ops.admm_batched import (admm_batched,
                                                           admm_cluster,
                                                           admm_stream,
                                                           batched_form,
                                                           kernel_for)


def _qps(B, n, m, seed, eq_rows=0):
    rng = np.random.default_rng(seed)
    Ph = rng.normal(size=(B, n, n))
    P = Ph @ Ph.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    mid = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.2)
    l = mid - rng.uniform(0.1, 1, (B, m))
    u = mid + rng.uniform(0.1, 1, (B, m))
    l[:, :eq_rows] = u[:, :eq_rows]
    rho = 0.1 * np.ones(m)
    rho[:eq_rows] *= 1000
    Kinv = np.array(jax.vmap(lambda P_, A_: jax_make_kinv(
        P_, A_, jnp.asarray(rho)))(jnp.asarray(P), jnp.asarray(A)))
    w0 = 0.1 * rng.normal(size=(B, n))
    y0 = 0.1 * rng.normal(size=(B, m))
    return Kinv, A, q, l, u, rho, w0, y0


# the chunk shapes of tests/test_pallas.py, B=1 and a ragged B=3 at the
# main path's n=20, m=40, and equality rows with a boosted rho
@pytest.mark.parametrize("B,n,m,eq", [(32, 12, 16, 0), (64, 20, 40, 0),
                                      (1, 20, 40, 0), (3, 20, 40, 0),
                                      (4, 24, 32, 5)])
def test_plain_matches_pallas(B, n, m, eq):
    args = _qps(B, n, m, seed=B + n, eq_rows=eq)
    w1, y1 = admm_batched_pallas(*[jnp.asarray(a) for a in args], 150,
                                 interpret=True)
    launches = admm_batched.launches
    w2, y2 = admm_batched(*[torch.as_tensor(a) for a in args], 150)
    assert admm_batched.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(w2.numpy(), np.asarray(w1), atol=1e-10)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y1), atol=1e-10)


@pytest.mark.parametrize("B,n,m,eq", [(3, 130, 140, 20), (1, 130, 140, 0),
                                      (2, 60, 200, 8)])
def test_plain_matches_pallas_grid_at_large_n(B, n, m, eq):
    """Sizes where the Pallas dispatch finds no chunk and takes the per-QP
    grid kernel, with one-sided and free rows (infinite bounds) and
    boosted equality rows, as the sparse LOCP has them. Tolerance 1e-10."""
    assert _pick_chunk(B, n, m, 8) == 0
    Kinv, A, q, l, u, rho, w0, y0 = _qps(B, n, m, seed=n, eq_rows=eq)
    l[:, eq:eq + 10] = -np.inf
    u[:, eq + 5:eq + 15] = np.inf
    args = (Kinv, A, q, l, u, rho, w0, y0)
    w1, y1 = _admm_batched_pallas_grid(*[jnp.asarray(a) for a in args], 60,
                                       interpret=True)
    targs = [torch.as_tensor(a) for a in args]
    for wrapper in (admm_batched, admm_cluster, admm_stream):
        launches = wrapper.launches
        w2, y2 = wrapper(*targs, 60)
        assert wrapper.launches == launches  # CPU tensors: no kernel
        assert torch.isfinite(w2).all() and torch.isfinite(y2).all()
        np.testing.assert_allclose(w2.numpy(), np.asarray(w1), atol=1e-10)
        np.testing.assert_allclose(y2.numpy(), np.asarray(y1), atol=1e-10)


@pytest.mark.parametrize("wrapper", [admm_batched, admm_cluster,
                                     admm_stream])
def test_wrapper_rejects_other_devices(wrapper):
    args = [torch.as_tensor(a).to("meta") for a in _qps(2, 4, 6, seed=0)]
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*args, 5)



@pytest.mark.parametrize("n,m,elem,form", [
    (20, 40, 4, "registers"), (1, 1, 4, "registers"), (32, 64, 4, "registers"),
    (33, 64, 4, "shared"), (32, 65, 4, "shared"), (100, 120, 4, "shared"),
    (20, 40, 8, "shared"), (1, 1, 8, "shared")])
def test_form_of_the_block_kernel(n, m, elem, form):
    """The register form takes the condensed LOCP (n=20, m=40) and every
    float32 QP up to 32 variables and 64 rows, the shared form the rest of
    what fits a block, float64 included; every register-form QP fits a
    block, so the choice among the three kernels does not change."""
    assert batched_form(n, m, elem) == form
    assert kernel_for(n, m, elem) == "admm_batched"
