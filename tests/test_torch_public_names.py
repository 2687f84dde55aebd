"""Public names of ported JAX files that the port lacked until it took
them: the top-level `__version__` and module bindings, `utils/io.py:
load_mat`, `qp/blocked.py:chol_blocked` and `tri_inv_blocked` (also bound
in `control/batch_mpc.py`, as in JAX) and `control/batch_mpc.py:
admm_staged_pallas`, each held to the JAX function. (`models/tpwl.py:
rollout` is held in tests/test_torch_model.py; that every public name of a
ported JAX file exists in its twin, in tests/test_torch_static.py.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import soft_robot_control_tpu as jpkg
import soft_robot_control_tpu_torch as tpkg
from soft_robot_control_tpu.control import batch_mpc as jbm
from soft_robot_control_tpu.utils.io import load_mat as jload_mat
from soft_robot_control_tpu_torch.control import batch_mpc as tbm
from soft_robot_control_tpu_torch.qp import blocked as tblocked
from soft_robot_control_tpu_torch.utils.io import load_mat

from torch_helpers import SSM_ARTIFACTS


def test_version_and_module_bindings():
    assert tpkg.__version__ == jpkg.__version__ == "0.1.0"
    for name in ("packing", "types", "discretize", "constraints"):
        mod = getattr(tpkg, name)
        assert mod.__name__ == f"soft_robot_control_tpu_torch.core.{name}"
        assert getattr(jpkg, name).__name__.endswith(f"core.{name}")


def _same_mat(a, b):
    """Equal .mat content: numbers equal, structs field by field, object
    arrays element by element."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.names == b.dtype.names
    if a.dtype.names:
        for k in a.dtype.names:
            for x, y in zip(a[k].ravel(), b[k].ravel()):
                _same_mat(x, y)
    elif a.dtype == object:
        for x, y in zip(a.ravel(), b.ravel()):
            _same_mat(x, y)
    else:
        assert np.array_equal(a, b)


def test_load_mat_reads_the_committed_trunk_artifact():
    """The trunk SSM artifact as scipy.io reads it, struct arrays kept (the
    reference's ``['py_data'][0, 0]`` indexing): the same content as the
    JAX package's load_mat."""
    got, ref = load_mat(SSM_ARTIFACTS["trunk"]), jload_mat(
        SSM_ARTIFACTS["trunk"])
    assert sorted(got) == sorted(ref) and "py_data" in got
    assert got["py_data"][0, 0].dtype.names == ("model", "params")
    _same_mat(got["py_data"], ref["py_data"])


def _spd(rng, B, n):
    """tests/test_blocked_linalg.py's inputs: Jacobi-scaled SPD matrices."""
    Ph = rng.normal(size=(B, n, n))
    K = Ph @ Ph.transpose(0, 2, 1) + 0.01 * np.eye(n)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", K))
    return K * d[:, :, None] * d[:, None, :]


@pytest.mark.parametrize("n", [13, 50, 64, 100, 137, 272])
def test_chol_blocked_is_the_jax_function(n):
    """The Cholesky factor within 1e-12 of the JAX package's recursive
    blocked one (relative, tests/test_blocked_linalg.py's bound against
    lax), `leaf` accepted; bound in batch_mpc too, as in JAX."""
    Ks = _spd(np.random.default_rng(n), 3, n)
    ref = np.asarray(jbm.chol_blocked(jnp.asarray(Ks)))
    got = tbm.chol_blocked(torch.as_tensor(Ks), leaf=16).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert tbm.chol_blocked is tblocked.chol_blocked


@pytest.mark.parametrize("n", [13, 64, 100, 137, 272])
def test_tri_inv_blocked_is_the_jax_function(n):
    """The triangular inverse within 1e-12 of the JAX package's (relative,
    as tests/test_blocked_linalg.py holds JAX's to the triangular solve)."""
    L = np.linalg.cholesky(_spd(np.random.default_rng(100 + n), 3, n))
    ref = np.asarray(jbm.tri_inv_blocked(jnp.asarray(L)))
    got = tbm.tri_inv_blocked(torch.as_tensor(L), leaf=32).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert tbm.tri_inv_blocked is tblocked.tri_inv_blocked


def test_admm_staged_pallas_is_the_jax_function():
    """The shim over admm_staged_batched with the JAX arguments (the JAX
    function runs its batched Pallas kernel in interpret mode; the port's
    `interpret` is ignored): w and y within 1e-9 of their scale."""
    rng = np.random.default_rng(4)
    B, n, m = 3, 6, 10
    Ph = rng.normal(size=(B, n, n))
    P = Ph @ Ph.transpose(0, 2, 1) + 0.1 * np.eye(n)
    A = rng.normal(size=(B, m, n))
    mid = np.einsum("bmn,bn->bm", A, 0.2 * rng.normal(size=(B, n)))
    l, u = mid - rng.uniform(0.1, 1, (B, m)), mid + rng.uniform(0.1, 1, (B, m))
    q = rng.normal(size=(B, n))
    w0, y0 = np.zeros((B, n)), np.zeros((B, m))
    rho = np.full(m, 0.1)
    args = (P, q, A, l, u, w0, y0, rho)
    ref = jbm.admm_staged_pallas(*map(jnp.asarray, args), 40, 4, True)
    jax.block_until_ready(ref)
    got = tbm.admm_staged_pallas(*map(torch.as_tensor, args), 40, 4,
                                 interpret=True)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-9 * max(1.0, np.abs(r).max())
