"""Idle device ms a batched MPC window (a step of all B loops) while the
host is in the self time of `mpc.call` or `mpc.window` (the plan shift,
the warm start, the rho folding and reshapes of control/batch_mpc.py),
from the span pass (harness/spans.py)."""

from port_bench.harness.spans import per_window


def read(ctx):
    return per_window(ctx, ("mpc.call", "mpc.window"))
