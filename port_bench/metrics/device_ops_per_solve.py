"""Device operations a trajectory optimization costs in batched GuSTO (the
traced calls' kernels, copies and fills over their solves): the SCP logic
of scp/gusto_jit.py, masks and trust-region updates a batch at a time."""


def read(ctx):
    return len(ctx.trace.events) / ctx.work
