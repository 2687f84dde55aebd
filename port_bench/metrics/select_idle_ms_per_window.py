"""Idle device ms a batched MPC window while the host is in `tpwl.select`
(ops/tpwl_select.py: the checks, outputs and launch of kernel 2), from the
span pass (harness/spans.py)."""

from port_bench.harness.spans import per_window


def read(ctx):
    return per_window(ctx, ("tpwl.select",))
