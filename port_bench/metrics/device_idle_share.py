"""The device's idle share over the traced calls: one minus the union of
its operations' intervals over the host clock's window."""


def read(ctx):
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
