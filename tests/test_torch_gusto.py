"""The host GuSTO loop (dense and condensed LOCP backends), its one-shot
real-time path, the plan bound, the device trust-region loop (device_tr)
and GuSTOService, against the JAX package, f64 on the CPU, on the Dubins
car and on a 64-point subset of the Diamond campaign dictionary at full
width (n_x=60, n_u=4, n_z=3). Iteration counts must be identical; the
tolerances on the plans are stated in each test. The dense backend's
solves run with polish=False: the polish step guesses the active set from
the signs of duals that can be rounding noise, and the two runtimes guess
differently (ROADMAP.md, section 3, faults found)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import CAMPAIGN_PARAMS, campaign_dict, campaign_output_maps

from soft_robot_control_tpu.control.service import GuSTOService as JaxService
from soft_robot_control_tpu.core.constraints import HyperRectangle as JaxBox
from soft_robot_control_tpu.models import tpwl as jtpwl
from soft_robot_control_tpu.models.dubins import DubinsCar as JaxDubins
from soft_robot_control_tpu.models.interfaces import TPWLGuSTO as JaxAdapter
from soft_robot_control_tpu.scp.gusto import GuSTO as JaxGuSTO
from soft_robot_control_tpu_torch.control.service import GuSTOService
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.models import tpwl as ttpwl
from soft_robot_control_tpu_torch.models.dubins import DubinsCar
from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
from soft_robot_control_tpu_torch.scp.gusto import GuSTO

ATOL = 1e-9


def _dubins(N=12, dt=0.1):
    """Both packages' Dubins car, costs, bounds (as (ub, lb)), target and
    initial guess."""
    jm, tm = JaxDubins(), DubinsCar(device="cpu")
    Qz, R = np.diag([1.0, 1.0, 0.0]), 0.1 * np.eye(2)
    z = np.tile(np.array([1.0, 1.0, 0.0]), (N + 1, 1))
    x0, u_init = np.zeros(3), np.zeros((N, 2))
    x_init = np.asarray(jm.rollout(x0, u_init, dt))
    return jm, tm, Qz, R, (2.0 * np.ones(2), -2.0 * np.ones(2)), z, x0, \
        u_init, x_init


def _same_plan(jg, tg, atol=ATOL):
    assert tg.itr_count == jg.itr_count
    for k in ("xopt", "uopt", "zopt"):
        ref = np.asarray(getattr(jg, k))
        np.testing.assert_allclose(getattr(tg, k), ref, rtol=0,
                                   atol=atol * max(1.0, np.abs(ref).max()),
                                   err_msg=k)


@pytest.mark.parametrize("backend", ["dense", "condensed"])
def test_host_loop_dubins(backend):
    """Construction solve (MAX_ITERS), then a later warm-started solve
    with max_gusto_iters=6 from a moved state."""
    N, dt = 12, 0.1
    jm, tm, Qz, R, U, z, x0, u_init, x_init = _dubins(N, dt)
    kw = dict(z=z, max_gusto_iters=6, convg_thresh=1e-3,
              locp_backend=backend, polish=False)
    jg = JaxGuSTO(jm, N, dt, Qz, R, x0, u_init, x_init, U=JaxBox(*U), **kw)
    tg = GuSTO(tm, N, dt, Qz, R, x0, u_init, x_init, U=HyperRectangle(*U),
               **kw)
    _same_plan(jg, tg)
    x1 = x0 + 0.05
    x_ws = np.asarray(jm.rollout(x1, jg.uopt, dt))
    jg.solve(x1, jg.uopt, x_ws, z=z)
    tg.solve(x1, tg.uopt, x_ws, z=z)
    _same_plan(jg, tg)
    assert tg.params.max_gusto_iters == 6


def test_host_loop_terminal_cost_dU_and_X():
    """The dense backend with Qzf/zf, dU, a state box X that binds, x_char
    and u_des."""
    N, dt = 15, 0.1
    jm, tm, _, R, _, _, x0, u_init, x_init = _dubins(N, dt)
    Qz, Qzf = np.zeros((3, 3)), 100.0 * np.eye(3)
    zf = np.array([2.0, 1.5, 0.0])
    x_char = np.array([1.0, 1.0, np.pi])
    box = ([0.8, 10.0, 10.0], [-10.0, -10.0, -10.0])
    dU = ([0.2, 0.2], [-0.2, -0.2])
    kw = dict(u=0.01 * np.ones((N, 2)), zf=zf, Qzf=Qzf, x_char=x_char,
              max_gusto_iters=8, polish=False)
    jg = JaxGuSTO(jm, N, dt, Qz, R, x0, u_init, x_init, dU=JaxBox(*dU),
                  X=JaxBox(*box), **kw)
    tg = GuSTO(tm, N, dt, Qz, R, x0, u_init, x_init,
               dU=HyperRectangle(*dU), X=HyperRectangle(*box), **kw)
    _same_plan(jg, tg, atol=1e-7)
    assert np.max(tg.xopt[1:, 0]) <= 0.8 + 1e-3


def _campaign_problem():
    Cf, Hf = campaign_output_maps()
    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    kw = dict(params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf, discr_method="be")
    ja = JaxAdapter(jtpwl.from_tpwl_dict(data, **kw))
    ta = TPWLGuSTO(ttpwl.from_tpwl_dict(data, device="cpu", **kw))
    rng = np.random.default_rng(2)
    N = 5
    x0 = 0.05 * rng.normal(size=60)
    z = 0.5 * rng.normal(size=(N + 1, 3))
    return ja, ta, N, x0, z


def test_host_loop_campaign_condensed():
    """The condensed backend at the campaign's full width: 20 inputs, a
    trust-region slack and 641 rows a QP."""
    ja, ta, N, x0, z = _campaign_problem()
    dt, U = 0.01, (1500.0 * np.ones(4), np.zeros(4))
    Qz, R = 100.0 * np.eye(3), 1e-3 * np.eye(4)
    u_init, x_init = np.zeros((N, 4)), np.repeat(x0[None], N + 1, 0)
    xc, fc = ta.get_characteristic_vals()
    kw = dict(z=z, max_gusto_iters=3, locp_backend="condensed", x_char=xc,
              f_char=fc)
    jg = JaxGuSTO(ja, N, dt, Qz, R, x0, u_init, x_init, U=JaxBox(*U), **kw)
    tg = GuSTO(ta, N, dt, Qz, R, x0, u_init, x_init,
               U=HyperRectangle(*U), **kw)
    _same_plan(jg, tg)
    assert tg.locp.spec.n_var == 21 and tg.locp.spec.n_con == 641


@pytest.mark.parametrize("rounds", [1, 2])
def test_oneshot_matches_jax(rounds):
    """The real-time path (max_gusto_iters=0, condensed, no trust region)
    over three warm-started replans, one or two relinearizations each."""
    N, dt = 12, 0.1
    jm, tm, Qz, R, U, z, x0, u_init, x_init = _dubins(N, dt)
    kw = dict(z=z, max_gusto_iters=0, is_tr_active=False,
              locp_backend="condensed", oneshot_iters=rounds)
    jg = JaxGuSTO(jm, N, dt, Qz, R, x0, u_init, x_init, U=JaxBox(*U), **kw)
    tg = GuSTO(tm, N, dt, Qz, R, x0, u_init, x_init, U=HyperRectangle(*U),
               **kw)
    assert tg._oneshot and jg._oneshot is not None
    _same_plan(jg, tg)
    for k in range(3):
        xk = x0 + 0.05 * k
        x_ws = np.asarray(jm.rollout(xk, jg.uopt, dt))
        jg.solve(xk, jg.uopt, x_ws, z=z)
        tg.solve(xk, tg.uopt, x_ws, z=z)
        _same_plan(jg, tg)
    np.testing.assert_allclose(tg._os_w.numpy(), np.asarray(jg._os_w),
                               rtol=0, atol=1e-9)
    assert tg.plan_rejects == jg.plan_rejects == 0


def test_plan_bound_rejects_and_keeps_the_old_plan(capsys):
    N, dt = 12, 0.1
    jm, tm, Qz, R, U, z, x0, u_init, x_init = _dubins(N, dt)
    kw = dict(z=z, max_gusto_iters=0, is_tr_active=False,
              locp_backend="condensed", plan_bound=1e-6)
    jg = JaxGuSTO(jm, N, dt, Qz, R, x0, u_init, x_init, U=JaxBox(*U), **kw)
    tg = GuSTO(tm, N, dt, Qz, R, x0, u_init, x_init, U=HyperRectangle(*U),
               **kw)
    u_prev = np.full((N, 2), 0.123)
    x_prev = np.asarray(jm.rollout(x0, u_prev, dt))
    jg.solve(x0, u_prev, x_prev, z=z)
    tg.solve(x0, u_prev, x_prev, z=z)
    assert "plan rejected" in capsys.readouterr().out
    np.testing.assert_allclose(tg.uopt, u_prev)
    np.testing.assert_allclose(tg.xopt, x_prev)
    assert float(tg._os_w.abs().max()) == 0.0
    assert tg.plan_rejects == jg.plan_rejects == 1
    assert [r["reason"] for r in tg.reject_log] == [
        r["reason"] for r in jg.reject_log] == ["excursion"]
    np.testing.assert_allclose([r["excursion"] for r in tg.reject_log],
                               [r["excursion"] for r in jg.reject_log],
                               rtol=1e-9)


def test_device_tr_matches_jax():
    """GuSTO(device_tr=True): the trust-region loop of GuSTOJit.solve_packed
    a query, on the Dubins car and then with a plan bound that rejects."""
    N, dt = 20, 0.1
    jm, tm, Qz, R, _, z, x0, u_init, x_init = _dubins(N, dt)
    U = ([1.0, 1.0], [0.0, -1.0])
    kw = dict(z=z, locp_backend="condensed", device_tr=True,
              device_tr_max_iters=10, device_tr_qp_iters=600,
              plan_bound=50.0)
    jg = JaxGuSTO(jm, N, dt, Qz, R, x0, u_init, x_init, U=JaxBox(*U),
                  dtype=jnp.float64, **kw)
    tg = GuSTO(tm, N, dt, Qz, R, x0, u_init, x_init, U=HyperRectangle(*U),
               dtype=torch.float64, **kw)
    _same_plan(jg, tg, atol=1e-8)
    assert tg.itr_count >= 1 and tg.plan_rejects == 0
    jg._plan_bound = tg._plan_bound = 1e-6
    jg.solve(x0, u_init, x_init, z=z)
    tg.solve(x0, u_init, x_init, z=z)
    assert tg.plan_rejects == jg.plan_rejects == 1
    np.testing.assert_allclose(tg.uopt, u_init)
    assert tg.reject_log[-1]["iters"] == jg.reject_log[-1]["iters"]


def test_service_matches_jax():
    """GuSTOService: interpolated moving targets with boundary fill, the
    previous plan shifted as the warm start, a solve on a background
    thread."""
    N, dt = 10, 0.1
    jm, tm, Qz, R, U, _, x0, _, _ = _dubins(N, dt)
    t = np.linspace(0.0, 1.2, 13)
    z = np.stack([np.sin(t), 0.5 * t, 0 * t], axis=1)
    kw = dict(t=t, z=z, max_gusto_iters=2, locp_backend="condensed")
    js = JaxService(jm, N, dt, Qz, R, x0, U=JaxBox(*U), **kw)
    ts = GuSTOService(tm, N, dt, Qz, R, x0, U=HyperRectangle(*U), **kw)
    for k, t0 in enumerate((0.0, 0.2, 0.45, 1.5)):
        xk = js.xopt[2] if k else x0
        js.send_request(t0, xk, wait=True)
        ts.send_request(t0, xk, wait=bool(k % 2))
        tj, uj, xj, _ = js.get_solution()
        tt, ut, xt, _ = ts.get_solution()
        assert ts.check_if_done()
        np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-15)
        np.testing.assert_allclose(ut, uj, rtol=0, atol=ATOL)
        np.testing.assert_allclose(xt, xj, rtol=0, atol=ATOL)
    z_t, zf_t, u_t = ts.get_target(1.5)
    np.testing.assert_allclose(z_t, js.get_target(1.5)[0])
    np.testing.assert_allclose(z_t[-1], z[-1])  # filled past the end


def test_unported_options_raise():
    N, dt = 4, 0.1
    _, tm, Qz, R, U, z, x0, u_init, x_init = _dubins(N, dt)
    with pytest.raises(NotImplementedError, match="item 13"):
        GuSTO(tm, N, dt, Qz, R, x0, u_init, x_init, locp_backend="stage")
    tm.nonlinear_observer = True
    with pytest.raises(NotImplementedError, match="item 11"):
        GuSTO(tm, N, dt, Qz, R, x0, u_init, x_init)
