"""Device milliseconds a batched MPC window (a step of all B loops) spends
in operations that are not the program's hand kernels: the QP build
(scp/locp_condensed.py), the Ruiz scaling and the rho rebalancing
(control/batch_mpc.py, qp/admm.py), K^-1 (qp/blocked.py) and the ticks
(estimators/ekf.py)."""


def read(ctx):
    return 1e3 * ctx.trace.library()[0] / ctx.steps
