"""Device ms a batched MPC window of the operations launched inside the
QP-build and tick spans (harness/spans.py QP_BUILD), each put down to the
span around the runtime call that launched it: the span pass's counterpart
of library_ms_per_window."""

from port_bench.harness.spans import QP_BUILD, per_window


def read(ctx):
    return per_window(ctx, QP_BUILD, "device_ms")
