"""The LTI MPC service (LinearMPCService, run_linear_mpc) against the JAX
package, f64 on the CPU: the dense (sparse LOCP) and condensed LOCP
backends, and on the condensed one both QP backends, 'xla' (the adaptive
dense ADMM) and 'pallas' (the fixed-budget staged ADMM through the batched
kernel; the JAX side runs its Pallas kernel in interpret mode). On a small
random LTI system and on the Diamond campaign's linear ROM at full width
(n_x=60, n_u=4, n_z=3). Plans are held to 1e-8 of their scale."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import CAMPAIGN, campaign_output_maps

from soft_robot_control_tpu.control import linear_mpc as jlm
from soft_robot_control_tpu.core.constraints import HyperRectangle as JaxBox
from soft_robot_control_tpu.core.types import QuadraticCost as JaxCost
from soft_robot_control_tpu.core.types import Target as JaxTarget
from soft_robot_control_tpu.models import linear as jlin
from soft_robot_control_tpu_torch.control import linear_mpc as tlm
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.core.types import QuadraticCost, Target
from soft_robot_control_tpu_torch.models import linear as tlin

TOL = 1e-8


def _lti(seed=9):
    rng = np.random.default_rng(seed)
    nx, nu, nz = 4, 2, 2
    H = np.zeros((nz, nx))
    H[0, 0] = H[1, 1] = 1.0

    class LTI:
        A_d = 0.9 * np.eye(nx) + 0.02 * rng.normal(size=(nx, nx))
        B_d = 0.1 * rng.normal(size=(nx, nu))
        d_d = 0.01 * rng.normal(size=nx)

    LTI.H = H
    tt = 0.05 * np.arange(40) + 3.0
    zt = np.stack([np.sin(tt), np.cos(tt)], axis=1)
    ut = 0.1 * np.stack([np.cos(tt), np.sin(tt)], axis=1)
    return LTI(), tt, zt, ut, rng


def _pair(model_j, model_t, N, dt, Q, R, Qf, t, z, u, ub, **kw):
    jcost = JaxCost(Q=Q, R=R, Qf=Qf)
    tcost = QuadraticCost(Q=Q, R=R, Qf=Qf)
    js = jlm.LinearMPCService(model_j, N, dt, jcost,
                              JaxTarget(t=t, z=z, u=u),
                              U=JaxBox(ub, -ub), **kw)
    ts = tlm.LinearMPCService(model_t, N, dt, tcost, Target(t=t, z=z, u=u),
                              U=HyperRectangle(ub, -ub), device="cpu", **kw)
    return js, ts


def _same(js, ts, tol=TOL):
    ref, got = js.get_solution(), ts.get_solution()
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-14)
    for r, g in zip(ref[1:3], got[1:3]):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=tol * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("backend", [
    dict(locp_backend="dense", polish=False),
    dict(locp_backend="condensed"),
    dict(locp_backend="condensed", qp_backend="pallas", qp_iters=200,
         rho_stages=4)])
def test_service_matches_jax(backend):
    """Three replans along the plan from a random state, moving z and u
    targets (interpolated, times offset by t[0]), terminal cost."""
    m, tt, zt, ut, rng = _lti()
    js, ts = _pair(m, m, 8, 0.05, 10.0 * np.eye(2), 0.1 * np.eye(2),
                   20.0 * np.eye(2), tt, zt, ut, 2.0 * np.ones(2), **backend)
    x = 0.1 * rng.normal(size=4)
    for k in range(3):
        t0 = 3.0 + 0.05 * k + 0.013
        js.send_request(t0, x, wait=True)
        ts.send_request(t0, x, wait=bool(k != 1))
        _same(js, ts)
        x = ts.get_solution()[2][1]


def test_fixed_budget_first_failure_and_plan_extension(capsys):
    """A 'pallas' budget too small to pass the gates: the first query is
    solved again by the adaptive host adapter, the next one extends the
    previous plan, in both packages."""
    m, tt, zt, _, rng = _lti(3)
    js, ts = _pair(m, m, 6, 0.05, 10.0 * np.eye(2), 0.1 * np.eye(2), None,
                   tt, zt, None, 0.05 * np.ones(2), locp_backend="condensed",
                   qp_backend="pallas", qp_iters=4, rho_stages=2)
    x = rng.normal(size=4)
    for k in range(2):
        js.send_request(3.0 + 0.05 * k, x, wait=True)
        ts.send_request(3.0 + 0.05 * k, x, wait=True)
        _same(js, ts, tol=1e-7)
    out = capsys.readouterr().out
    assert "FIRST solve not accepted" in out and "extending previous" in out


def test_target_reassignment_and_constant_targets():
    m, tt, zt, _, rng = _lti(5)
    js, ts = _pair(m, m, 5, 0.05, np.eye(2), 0.1 * np.eye(2), None, tt, zt,
                   None, 2.0 * np.ones(2), locp_backend="condensed")
    const = np.array([0.3, -0.2])
    js.target = JaxTarget(z=const, u=np.array([0.05, 0.0]))
    ts.target = Target(z=const, u=np.array([0.05, 0.0]))
    x = rng.normal(size=4)
    js.send_request(0.0, x)
    ts.send_request(0.0, x)
    _same(js, ts)


def test_run_linear_mpc_on_the_campaign_rom():
    """The campaign's linear ROM, the bench's LTI settings at a horizon of
    8 (n=32 inputs, m=64 rows), through the fixed-budget path."""
    Cf, Hf = campaign_output_maps()
    data = jlin.tpwl_to_linear_rom(CAMPAIGN)
    jl = jlin.LinearROM(data, 0.01, Cf=Cf, Hf=Hf)
    tl = tlin.LinearROM(data, 0.01, Cf=Cf, Hf=Hf, device="cpu")
    tt = 0.01 * np.arange(200)
    zt = np.zeros((len(tt), 3))
    zt[:, 0] = 15.0 * np.sin(2 * np.pi * tt / 2.0)
    zt[:, 1] = 7.5 * np.sin(4 * np.pi * tt / 2.0)
    zt = zt - np.asarray(jl.z_ref)
    kw = dict(locp_backend="condensed", qp_backend="pallas")
    args = (8, 0.01)
    cost = dict(Q=100.0 * np.eye(3), R=1e-4 * np.eye(4),
                Qf=1000.0 * np.eye(3))
    U = (1500.0 * np.ones(4), np.zeros(4))
    ref = jlm.run_linear_mpc(jl, *args, JaxCost(**cost), np.zeros(60),
                             JaxTarget(t=tt, z=zt), U=JaxBox(*U), **kw)
    got = tlm.run_linear_mpc(tl, *args, QuadraticCost(**cost), np.zeros(60),
                             Target(t=tt, z=zt), U=HyperRectangle(*U), **kw)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=TOL * max(1.0, np.abs(r).max()))


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(0)
    xp = np.cumsum(rng.uniform(0.1, 1.0, 12))
    xp[5] = xp[4]  # a repeated knot
    fp = rng.normal(size=(12, 3))
    x = np.concatenate([rng.uniform(xp[0] - 1, xp[-1] + 1, 40), xp])
    ref = np.stack([np.asarray(jnp.interp(x, xp, fp[:, c]))
                    for c in range(3)], axis=1)
    got = tlm.interp(torch.as_tensor(x), torch.as_tensor(xp),
                     torch.as_tensor(fp))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14)


def test_unknown_qp_backend_raises():
    m, tt, zt, _, _ = _lti()
    with pytest.raises(ValueError, match="qp_backend"):
        tlm.LinearMPCService(m, 4, 0.05, QuadraticCost(np.eye(2), np.eye(2)),
                             Target(t=tt, z=zt), qp_backend="triton",
                             device="cpu")
