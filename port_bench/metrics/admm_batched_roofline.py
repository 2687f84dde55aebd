"""Kernel 1's (ops/admm_batched.py, csrc/admm_batched.cu) share of its
roofline: the least time of its launches' work, counted from the QPs'
shapes (harness/roofline.py), over the time of its device operations in
the trace. A trace without them is an error."""


def read(ctx):
    return ctx.roofline_percent("admm_batched")
