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
from soft_robot_control_tpu_torch.ops.admm_batched import (
    _SMEM_LIMIT, admm_batched, admm_batched_plain, admm_cluster, admm_stream,
    batched_form, block_layout, cluster_plan, kernel_for, qp_bytes)


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
    (33, 64, 4, "block"), (32, 65, 4, "block"), (100, 120, 4, "block"),
    (20, 40, 8, "block"), (1, 1, 8, "block")])
def test_form_of_the_block_kernel(n, m, elem, form):
    """The register form takes the condensed LOCP (n=20, m=40) and every
    float32 QP up to 32 variables and 64 rows, the block form the rest of
    what fits a block, float64 included; every register-form QP fits a
    block, so the choice among the three kernels does not change."""
    assert batched_form(n, m, elem) == form
    assert kernel_for(n, m, elem) == "admm_batched"


# PERF.md section 6's rows and chip_smoke.py phase 3's random QPs: (row,
# B, n, m, element size, kernel, form of admm_batched.cu where it runs)
PATH_SHAPES = [
    ("1", 1024, 20, 40, 4, "admm_batched", "registers"),
    ("1 f64", 8, 20, 40, 8, "admm_batched", "block"),
    ("1b", 64, 21, 641, 4, "admm_batched", "block"),
    ("1b f64", 64, 21, 641, 8, "admm_batched", "block"),
    ("1c", 1, 80, 160, 4, "admm_batched", "block"),
    ("1d", 1024, 24, 1, 4, "admm_batched", "registers"),
    ("1e", 1024, 48, 24, 4, "admm_batched", "block"),
    ("1f", 1, 80, 1, 4, "admm_batched", "block"),
    ("1g", 1, 40, 152, 4, "admm_batched", "block"),
    ("phase 3", 1024, 100, 120, 4, "admm_batched", "block"),
    ("phase 3 f64", 3, 100, 120, 8, "admm_batched", "block"),
    ("3", 1024, 380, 400, 4, "admm_cluster", None),
    ("3b", 1024, 380, 400, 8, "admm_stream", None),
    ("3c", 64, 386, 1126, 4, "admm_stream", None),
    ("3c f64", 64, 386, 1126, 8, "admm_stream", None)]


@pytest.mark.parametrize("row,B,n,m,elem,kernel,form", PATH_SHAPES,
                         ids=[r[0] for r in PATH_SHAPES])
def test_every_path_shape_goes_to_its_kernel_and_form(row, B, n, m, elem,
                                                      kernel, form):
    """The Python mirrors of the two dispatch rules at the paths' shapes:
    which kernel (`kernel_for`) and, inside admm_batched.cu, which form
    (`batched_form`) with a block layout that fits; the streaming kernel's
    QPs fit no cluster but have a plan on 8 blocks."""
    assert kernel_for(n, m, elem) == kernel
    if kernel == "admm_batched":
        assert batched_form(n, m, elem) == form
        lay = block_layout(B, n, m, elem)
        assert 64 <= lay["threads"] <= 1024 and lay["threads"] % 32 == 0
        assert lay["groups"] * n <= max(lay["threads"], n)
        assert qp_bytes(n, m, elem) <= lay["block_bytes"] <= _SMEM_LIMIT
    elif kernel == "admm_stream":
        assert cluster_plan(n, m, elem) is None
        plan = cluster_plan(n, m, elem, stream=True)
        assert plan["R"] == 8 and not plan["resident"]
        assert plan["block_bytes"] <= _SMEM_LIMIT


# the new forms' shapes (GuSTO condensed, Koopman MPC, the LTI service:
# the Pallas dispatch takes its per-QP grid kernel there) and GuSTO's
# sparse LOCP (the streaming kernel's), with rows of infinite bounds
@pytest.mark.parametrize("B,n,m,grid", [(2, 21, 641, False),
                                        (1, 40, 152, False),
                                        (1, 80, 160, False),
                                        (2, 386, 1126, True)])
def test_plain_matches_pallas_at_the_new_forms_shapes(B, n, m, grid):
    """The plain version (the CUDA kernels' oracle on the card) against
    admm_batched_pallas, or _admm_batched_pallas_grid, in interpret mode:
    1e-10 in f64, one-sided and free rows included."""
    Kinv, A, q, l, u, rho, w0, y0 = _qps(B, n, m, seed=m)
    l[:, :m // 8] = -np.inf
    u[:, m // 8:m // 4] = np.inf
    args = (Kinv, A, q, l, u, rho, w0, y0)
    jargs = [jnp.asarray(a) for a in args]
    if grid:
        w1, y1 = _admm_batched_pallas_grid(*jargs, 40, interpret=True)
    else:
        w1, y1 = admm_batched_pallas(*jargs, 40, interpret=True)
    w2, y2 = admm_batched_plain(*[torch.as_tensor(a) for a in args], 40)
    assert torch.isfinite(w2).all() and torch.isfinite(y2).all()
    np.testing.assert_allclose(w2.numpy(), np.asarray(w1), atol=1e-10)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y1), atol=1e-10)


@pytest.mark.parametrize("B", [1, 3, 64, 132, 133, 1024, 5000])
@pytest.mark.parametrize("n,m,elem", [(21, 641, 4), (21, 641, 8),
                                      (48, 24, 4), (100, 120, 4),
                                      (100, 120, 8), (80, 1, 4),
                                      (1, 1, 8), (150, 10, 4)])
def test_block_layout_fits_the_card(B, n, m, elem):
    """Threads a multiple of 32 in [64, 1024], never more than the blocks
    an SM holds at once leave room for; every (group, column) pair has a
    thread; the partials fit beside the QP."""
    lay = block_layout(B, n, m, elem)
    t, G = lay["threads"], lay["groups"]
    assert 64 <= t <= 1024 and t % 32 == 0
    assert 1 <= G <= m and (G == 1 or G * n <= t)
    assert lay["block_bytes"] == (qp_bytes(n, m, elem)
                                  + (G * n * elem if G > 1 else 0))
    assert lay["block_bytes"] <= _SMEM_LIMIT
    per_sm = min(max(-(-B // 132), 1), _SMEM_LIMIT // qp_bytes(n, m, elem))
    assert t <= max(1024 // per_sm // 32 * 32, 64)
