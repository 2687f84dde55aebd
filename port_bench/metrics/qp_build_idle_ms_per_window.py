"""Idle device ms a batched MPC window while the host builds the QPs or
runs the ticks: `qp.assemble`, `qp.ruiz`, `qp.kinv`, `qp.rho`,
`qp.recover`, `ekf.correct` and the self time of `mpc.tick`, from the span
pass (harness/spans.py)."""

from port_bench.harness.spans import QP_BUILD, per_window


def read(ctx):
    return per_window(ctx, QP_BUILD)
