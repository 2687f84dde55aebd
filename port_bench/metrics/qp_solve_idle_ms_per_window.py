"""Idle device ms a batched MPC window while the host is in `qp.admm`
(ops/admm_batched.py: the outputs and launch of kernel 1), from the span
pass (harness/spans.py)."""

from port_bench.harness.spans import per_window


def read(ctx):
    return per_window(ctx, ("qp.admm",))
