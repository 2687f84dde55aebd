"""The drivers of the traffic kinds, one module a kind, found by name.

A driver module defines `Driver(cfg, traffic, seed, device, program)`
with `setup()`, `call(i)`, `finite(out)`, `release()`,
`check(kept) -> {number: value}`, `launches() -> [(kernel, shape)]` of
one call, and the attributes `throughput` ((metric, unit)) and
`work_per_call`. `program` is "port" for the system under test and
"control" for the reference in the control's precision in its place.
"""
