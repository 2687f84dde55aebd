"""Kernel 2's (ops/tpwl_select.py, csrc/tpwl_select.cu) share of its
roofline: the least time of the selects' work, counted from the states,
points and rows (harness/roofline.py), over the time of its device
operations in the trace. A trace without them is an error."""


def read(ctx):
    return ctx.roofline_percent("tpwl_select")
