"""The port's sparse LOCP against the JAX package, f64 on the CPU:
`LOCPSpec.assemble` to 1e-12 on (P, q, A, l, u, const) with the infinite
bounds in the same places, its layout and `split`, and the stateful `LOCP`
(update / solve / get_solution) on a small tracking problem."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.core.constraints import HyperRectangle as JBox
from soft_robot_control_tpu.scp import locp as jl
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.scp import locp as tl

N, NX, NU, NZ = 4, 6, 2, 3
ATOL = 1e-12

# constructor options by case; boxes are (ub, lb) pairs, made per package
CASES = {
    "plain": dict(is_tr_active=False),
    "U_dU": dict(is_tr_active=False, U=(np.array([3.0, 2.0]), np.zeros(2)),
                 dU=(0.5 * np.ones(2), -0.5 * np.ones(2))),
    "trust_region": dict(is_tr_active=True,
                         x_char=np.array([1.0, 2.0, 0.5, 1.0, 4.0, 0.1]),
                         U=(np.ones(2), -np.ones(2))),
    "X_Xf_Qzf": dict(is_tr_active=False, Qzf=True,
                     X=(np.ones(NX), -2.0 * np.ones(NX)),
                     Xf=(0.5 * np.ones(NX), -0.5 * np.ones(NX))),
    "nonlinear_observer": dict(is_tr_active=True, nonlinear_observer=True,
                               Qzf=True, X=(np.ones(NZ), -np.ones(NZ)),
                               U=(np.ones(2), np.zeros(2))),
    "input_nullspace": dict(is_tr_active=False, input_nullspace=True),
}
ROW_OFFSETS = ("r_init", "r_dyn", "r_tr", "r_s", "r_U", "r_dU", "r_X", "r_Xf")


def _specs(case):
    """The JAX and the port spec of a case, from the same numpy data."""
    rng = np.random.default_rng(7)
    H = rng.normal(size=(NZ, NX))
    Qh = rng.normal(size=(NZ, NZ))
    Qz = Qh @ Qh.T + np.eye(NZ)
    R = 0.1 * np.eye(NU) + 0.01 * np.ones((NU, NU))
    out = []
    for Box, Spec, kw in ((JBox, jl.LOCPSpec, dict(dtype=jnp.float64)),
                          (HyperRectangle, tl.LOCPSpec,
                           dict(dtype=torch.float64, device="cpu"))):
        opts = dict(CASES[case])
        for k in ("U", "dU", "X", "Xf"):
            if k in opts:
                opts[k] = Box(*opts[k])
        if opts.pop("Qzf", False):
            opts["Qzf"] = 2.0 * Qz
        if opts.pop("input_nullspace", False):
            opts["input_nullspace"] = np.array([[1.0, -1.0]])
        out.append(Spec(N, H, Qz, R, **opts, **kw))
    return out


def _params(B, seed):
    rng = np.random.default_rng(seed)
    return dict(
        Ad=np.eye(NX) + 0.1 * rng.normal(size=(B, N, NX, NX)),
        Bd=rng.normal(size=(B, N, NX, NU)), dd=rng.normal(size=(B, N, NX)),
        x0=rng.normal(size=(B, NX)), xk=rng.normal(size=(B, N + 1, NX)),
        delta=rng.uniform(0.5, 2.0, size=B), omega=rng.uniform(1, 10, size=B),
        z=rng.normal(size=(B, N + 1, NZ)), zf=rng.normal(size=(B, NZ)),
        u_des=rng.normal(size=(B, N, NU)),
        Hd=rng.normal(size=(B, N + 1, NZ, NX)),
        cd=rng.normal(size=(B, N + 1, NZ)))


@pytest.mark.parametrize("case", list(CASES))
def test_assemble_matches_jax(case):
    jspec, tspec = _specs(case)
    B = 3
    p = _params(B, seed=len(case))
    ref = jax.vmap(jspec.assemble)(jl.LOCPParams(
        **{k: jnp.asarray(v) for k, v in p.items()}))
    ref = [np.asarray(a) for a in ref]
    got = tspec.assemble(tl.LOCPParams(
        **{k: torch.as_tensor(v) for k, v in p.items()}))
    for name, a, b in zip("PqAluc", got, ref):
        a = a.numpy()
        assert a.shape == b.shape, name
        inf = np.isinf(b)
        assert np.array_equal(np.isinf(a), inf), name
        assert np.array_equal(np.sign(a[inf]), np.sign(b[inf])), name
        np.testing.assert_allclose(a[~inf], b[~inf], atol=ATOL, rtol=0,
                                   err_msg=name)
    # a second assembly starts from the untouched static template
    again = tspec.assemble(tl.LOCPParams(
        **{k: torch.as_tensor(v) for k, v in p.items()}))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", list(CASES))
def test_layout_and_split_match_jax(case):
    jspec, tspec = _specs(case)
    for name in ("n_var", "n_con", "off_x", "off_u", "off_s") + ROW_OFFSETS:
        assert getattr(tspec, name, None) == getattr(jspec, name, None), name
    w = np.random.default_rng(0).normal(size=(2, tspec.n_var))
    got = tspec.split(torch.as_tensor(w))
    for b in range(2):
        ref = jspec.split(jnp.asarray(w[b]))
        for a, r in zip(got, ref):
            assert (a is None) == (r is None)
            if r is not None:
                np.testing.assert_array_equal(a[b].numpy(), np.asarray(r))


def test_spec_defaults_to_the_trust_region_like_jax():
    rng = np.random.default_rng(1)
    H = rng.normal(size=(NZ, NX))
    tspec = tl.LOCPSpec(N, H, np.eye(NZ), np.eye(NU), device="cpu")
    jspec = jl.LOCPSpec(N, H, np.eye(NZ), np.eye(NU))
    assert tspec.tr_active and jspec.tr_active
    assert (tspec.n_var, tspec.n_con) == (jspec.n_var, jspec.n_con)
    assert tspec.dtype == torch.float64


@pytest.mark.parametrize("tr", [False, True])
def test_locp_solve_matches_jax(tr):
    """update / solve / get_solution of the stateful wrapper, cold and
    warm: x, u to 1e-6, the same success flag, J* to 1e-6 relative.
    Without the polish: its active-set guess reads the sign of duals that
    are rounding noise (1e-17) on rows that were active and released, so it
    is not reproducible between two runtimes; tests/test_torch_qp.py holds
    it on QPs where the guess is unambiguous."""
    rng = np.random.default_rng(3)
    H = rng.normal(size=(NZ, NX))
    kw = dict(Qzf=np.eye(NZ), is_tr_active=tr, polish=False)
    U = (2.0 * np.ones(NU), -2.0 * np.ones(NU))
    jlocp = jl.LOCP(N, H, 10.0 * np.eye(NZ), 0.1 * np.eye(NU), U=JBox(*U),
                    **kw)
    tlocp = tl.LOCP(N, H, 10.0 * np.eye(NZ), 0.1 * np.eye(NU),
                    U=HyperRectangle(*U), device="cpu", **kw)
    p = {k: v[0] for k, v in _params(1, seed=5).items()}
    p["Ad"] = 0.9 * np.eye(NX) + 0.05 * rng.normal(size=(N, NX, NX))
    for shift in (0.0, 0.05):  # the second solve is warm-started
        args = ([a for a in p["Ad"]], [b for b in p["Bd"]],
                [d for d in p["dd"]], p["x0"] + shift, p["xk"], 1.5, 2.0)
        opt = dict(z=p["z"], zf=p["zf"], u=p["u_des"])
        jlocp.update(*args, **opt)
        tlocp.update(*args, **opt)
        Jj, okj, _ = jlocp.solve()
        Jt, okt, stats = tlocp.solve()
        assert okj and okt and stats is tlocp
        assert abs(Jt - Jj) <= 1e-6 * max(1.0, abs(Jj))
        for a, b in zip(tlocp.get_solution(), jlocp.get_solution()):
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
