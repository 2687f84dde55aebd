"""The completed condensed LOCP: `CondensedSpec.assemble` with every option
(trust region, X, Qzf, the time-varying output map Hd/cd, U, dU) and
`CondensedLOCPAdapter`, against the JAX package, f64 on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.core.constraints import HyperRectangle as JaxBox
from soft_robot_control_tpu.scp import locp_condensed as jlc
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.scp.locp_condensed import (
    CondensedLOCPAdapter, CondensedParams, CondensedSpec)

N, NX, NU, NZ, B = 4, 5, 2, 3, 3
ATOL = 1e-12


def _problem(seed):
    """Random stable linearizations and targets for a batch of B problems,
    numpy f64."""
    rng = np.random.default_rng(seed)
    Ad = 0.9 * np.eye(NX) + 0.05 * rng.normal(size=(B, N, NX, NX))
    return dict(
        Ad=Ad, Bd=0.2 * rng.normal(size=(B, N, NX, NU)),
        dd=0.01 * rng.normal(size=(B, N, NX)), x0=rng.normal(size=(B, NX)),
        z=rng.normal(size=(B, N + 1, NZ)), u_des=rng.normal(size=(B, N, NU)),
        Hd=rng.normal(size=(B, N + 1, NZ, NX)),
        cd=rng.normal(size=(B, N + 1, NZ)),
        xk=rng.normal(size=(B, N + 1, NX)),
        delta=rng.uniform(0.5, 2.0, size=B), omega=rng.uniform(1, 3, size=B),
        zf=rng.normal(size=(B, NZ)))


def _sets(rng, Box):
    U = Box(np.full(NU, 1.5), np.full(NU, -1.0))
    dU = Box(np.full(NU, 0.3), np.full(NU, -0.3))
    X = Box(np.full(NX, 2.0), np.full(NX, -2.5))
    return U, dU, X


OPTIONS = {
    "tr_X_U_dU_Qzf": dict(trust_region=True, X=True, U=True, dU=True,
                          Qzf=True),
    "tr_only": dict(trust_region=True),
    "X_only": dict(X=True),
    "observer_tr_Qzf": dict(nonlinear_observer=True, trust_region=True,
                            Qzf=True, U=True),
    "observer_X": dict(nonlinear_observer=True, X=True, dU=True),
    "unconstrained": dict(),
    "U_dU_Qzf": dict(U=True, dU=True, Qzf=True),
}


def _specs(opts):
    rng = np.random.default_rng(3)
    H = rng.normal(size=(NZ, NX))
    Qz = np.diag(rng.uniform(0.5, 2.0, NZ))
    R = np.diag(rng.uniform(0.1, 0.3, NU))
    Qzf = 10.0 * np.eye(NZ) if opts.get("Qzf") else None
    x_char = rng.uniform(0.5, 3.0, NX)
    kw = dict(nonlinear_observer=opts.get("nonlinear_observer", False),
              trust_region=opts.get("trust_region", False), x_char=x_char)
    out = []
    for Box, Spec, extra in (
            (JaxBox, jlc.CondensedSpec, dict(dtype=jnp.float64)),
            (HyperRectangle, CondensedSpec,
             dict(dtype=torch.float64, device="cpu"))):
        U, dU, X = _sets(rng, Box)
        out.append(Spec(N, H, Qz, R, U=U if opts.get("U") else None,
                        dU=dU if opts.get("dU") else None,
                        X=X if opts.get("X") else None, Qzf=Qzf, **kw,
                        **extra))
    return out


def _jax_assemble(jspec, p):
    def one(b):
        return jspec.assemble(jlc.CondensedParams(**{
            k: jnp.asarray(v[b]) for k, v in p.items()}))
    outs = [one(b) for b in range(B)]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(8)]


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_assemble_matches_jax(name):
    jspec, tspec = _specs(OPTIONS[name])
    p = _problem(11)
    ref = _jax_assemble(jspec, p)
    got = tspec.assemble(CondensedParams(**{
        k: torch.as_tensor(v) for k, v in p.items()}))
    assert (tspec.n_var, tspec.n_con) == (jspec.n_var, jspec.n_con)
    for r, g, what in zip(ref, got, ("P", "q", "A", "l", "u", "const",
                                     "xfree", "G")):
        assert tuple(g.shape) == r.shape, what
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=ATOL,
                                   err_msg=what)
    # recover_x, with the trailing slack present where the spec has one
    w = np.random.default_rng(5).normal(size=(B, tspec.n_var))
    ref_x = np.stack([np.asarray(jspec.recover_x(
        jnp.asarray(ref[6][b]), jnp.asarray(ref[7][b]), jnp.asarray(w[b])))
        for b in range(B)])
    np.testing.assert_allclose(tspec.recover_x(got[6], got[7],
                                               torch.as_tensor(w)).numpy(),
                               ref_x, rtol=0, atol=ATOL)


def test_trust_region_rows_are_per_problem_and_contiguous():
    """With the trust region A depends on G: a fresh contiguous tensor per
    problem, as the batched ADMM kernel takes it."""
    _, tspec = _specs(OPTIONS["tr_X_U_dU_Qzf"])
    p = _problem(12)
    A = tspec.assemble(CondensedParams(**{
        k: torch.as_tensor(v) for k, v in p.items()}))[2]
    assert A.is_contiguous()
    assert not torch.equal(A[0], A[1])


@pytest.mark.parametrize("tr", [True, False])
def test_adapter_matches_jax(tr):
    """update / solve / get_solution of the adapter, f64, warm-started over
    three solves, against the JAX adapter."""
    rng = np.random.default_rng(21)
    H = rng.normal(size=(NZ, NX))
    Qz, R = np.eye(NZ), 0.2 * np.eye(NU)
    x_char = np.full(NX, 2.0)
    ja = jlc.CondensedLOCPAdapter(N, H, Qz, R, U=JaxBox(np.ones(NU),
                                                        -np.ones(NU)),
                                  x_char=x_char, is_tr_active=tr,
                                  Qzf=None if tr else 5.0 * np.eye(NZ))
    ta = CondensedLOCPAdapter(N, H, Qz, R, U=HyperRectangle(np.ones(NU),
                                                            -np.ones(NU)),
                              x_char=x_char, is_tr_active=tr,
                              Qzf=None if tr else 5.0 * np.eye(NZ),
                              device="cpu")
    p = _problem(13)
    for k in range(3):
        args = (p["Ad"][k], p["Bd"][k], p["dd"][k], p["x0"][k], p["xk"][k],
                1.0, 2.0)
        kw = dict(z=p["z"][k], u=0.1 * p["u_des"][k],
                  zf=None if tr else p["zf"][k])
        ja.update(*args, **kw)
        ta.update(*args, **kw)
        Jj, okj, _ = ja.solve()
        Jt, okt, _ = ta.solve()
        assert okj and okt
        np.testing.assert_allclose(Jt, Jj, rtol=1e-9)
        for g, r in zip(ta.get_solution(), ja.get_solution()):
            np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-7)


def test_adapter_refuses_a_terminal_set():
    with pytest.raises(NotImplementedError, match="no-terminal-set"):
        CondensedLOCPAdapter(2, np.eye(1), np.eye(1), np.eye(1),
                             Xf=HyperRectangle([1.0], [-1.0]), device="cpu")
