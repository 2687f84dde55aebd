"""Host synchronisations a call (runtime calls that wait for the device,
one for each outermost host operation in a span), inside the calls' root
spans: `mpc.call`, `gusto.call` or `tpwl.rollout`, from the span pass
(harness/spans.py). The suffix of `host_syncs_per_call.<kind>` only tells
the cells apart."""

from port_bench.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if sp is None:
        return None
    sp.require(("mpc.call", "gusto.call", "tpwl.rollout"))
    return len(sp.syncs) / sp.calls
