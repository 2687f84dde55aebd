"""Device operations a batched MPC window launches (kernels, copies and
fills of the traced calls over their windows, each window a step of all B
loops): the host orchestration of control/batch_mpc.py, which pays some
microseconds of host time for each."""


def read(ctx):
    return len(ctx.trace.events) / ctx.steps
