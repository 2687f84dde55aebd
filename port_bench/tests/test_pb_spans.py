"""The span pass's reduction (harness/spans.py) on made-up events, and the
span metrics' readers: a parent and a call for each span, a device
operation put down through its launch's correlation id, a gap by its
midpoint, host synchronisations one an operation and none outside the
calls, and a reader that raises where its spans are missing."""

from types import SimpleNamespace

import pytest

from port_bench.harness import registry, spans
from port_bench.harness.spans import BETWEEN, Event, reduce

HOST, CUPTI = 1, 777    # the host ranges' thread id, the runtime calls'


def _span(name, a, b):
    return Event("span", name, a, b, thread=HOST)


def _rt(name, a, b, corr=0):
    return Event("runtime", name, a, b, corr, thread=CUPTI)


def _dev(name, a, b, corr=0):
    return Event("device", name, a, b, corr)


# two calls of a fleet, in ns. Call 0: a window whose K^-1 build reads the
# device (a copy to the host and a stream sync in one operation), a launch
# in the window's own code whose kernel runs after the window's span, and
# a tick; the harness's sync after it. Call 1: one launch, a copy to the
# device, and a kernel that no runtime call launched.
EVENTS = [
    _span("mpc.call", 0, 100), _span("mpc.window", 10, 60),
    _span("qp.kinv", 20, 40),
    Event("op", "aten::linalg_cholesky", 22, 35, thread=HOST),
    Event("op", "aten::_local_scalar_dense", 24, 34, thread=HOST),
    _rt("cudaMemcpyAsync", 25, 27, 5), _dev("Memcpy DtoH (Device -> "
                                            "Pageable)", 28, 29, 5),
    _rt("cudaStreamSynchronize", 27, 33, 6),
    _rt("cudaLaunchKernel", 41, 43, 7), _dev("k1", 50, 80, 7),
    _dev("mpc.window", 10, 60),         # the device's copy of a span
    _span("mpc.tick", 62, 90),
    _rt("cudaLaunchKernel", 63, 64, 8), _dev("k2", 81, 85, 8),
    _rt("cudaDeviceSynchronize", 101, 120),
    _span("mpc.call", 130, 150),
    _rt("cudaLaunchKernel", 131, 132, 9), _dev("k3", 133, 140, 9),
    _rt("cudaMemcpyAsync", 135, 136, 10),
    _dev("Memcpy HtoD (Pageable -> Device)", 136, 137, 10),
    _dev("k4", 142, 145, 99),
]


@pytest.fixture
def sp():
    return reduce(EVENTS)


def test_parents_and_calls(sp):
    got = [(s.name, s.parent, s.call) for s in sp.spans]
    assert got == [("mpc.call", -1, 0), ("mpc.window", 0, 0),
                   ("qp.kinv", 1, 0), ("mpc.tick", 0, 0),
                   ("mpc.call", -1, 1)]
    assert sp.calls == 2 and sp.count("mpc.window") == 1


def test_device_operations_go_to_the_span_of_their_launch(sp):
    assert sp.device_ms(("mpc.window",)) == pytest.approx(30e-6)
    assert sp.device_ms(("qp.kinv",)) == pytest.approx(1e-6)
    assert sp.device_ms(("mpc.tick",)) == pytest.approx(4e-6)
    assert sp.device_ms(("mpc.call",)) == pytest.approx(8e-6)
    # the copy of a span is no device operation; k4 has no launch
    assert len(sp.device) == 6
    assert [ok for _, _, ok in sp.device].count(False) == 1


def test_gaps_go_to_the_span_around_their_midpoint(sp):
    idle = {n: sp.idle_ms((n,)) * 1e6 for n in
            ("mpc.window", "qp.kinv", "mpc.tick", "mpc.call", BETWEEN)}
    assert idle == pytest.approx({"mpc.window": 28, "qp.kinv": 21,
                                  "mpc.tick": 1, "mpc.call": 7,
                                  BETWEEN: 48})
    busy = 1 + 30 + 4 + 7 + 3           # the copy to the device within k3
    assert sum(ns for ns, _ in sp.gaps) == 150 - busy == sum(idle.values())


def test_syncs_one_an_operation_inside_the_calls(sp):
    assert sp.syncs == [(2, "aten::linalg_cholesky: cudaMemcpyAsync")]
    assert sp.syncs_by_call() == [1, 0]
    table = {row[0]: row[1:] for row in sp.table()}
    assert table["qp.kinv"] == pytest.approx([0.5, 10e-6, 0.5e-6, 10.5e-6,
                                              0.5])
    # mpc.call's self time: 100 - 50 - 28 and 20, over 2 calls
    assert table["mpc.call"][1] == pytest.approx(21e-6)


def _read(name, sp):
    return registry.metric(name).read(SimpleNamespace(spans=sp))


def test_the_readers(sp):
    assert _read("orchestration_idle_ms_per_window", sp) == pytest.approx(
        35e-6)
    assert _read("qp_build_idle_ms_per_window", sp) == pytest.approx(22e-6)
    assert _read("qp_build_device_ms_per_window", sp) == pytest.approx(5e-6)
    assert _read("host_syncs_per_call.mpc", sp) == 0.5
    total = sum(_read(m, sp) for m in (
        "orchestration_idle_ms_per_window", "qp_build_idle_ms_per_window"))
    assert total + sp.idle_ms((BETWEEN,)) == pytest.approx(
        1e-6 * sum(ns for ns, _ in sp.gaps))


@pytest.mark.parametrize("name", ["select_idle_ms_per_window",
                                  "qp_solve_idle_ms_per_window"])
def test_a_reader_whose_spans_are_missing_raises(name, sp):
    with pytest.raises(RuntimeError, match="no span"):
        _read(name, sp)
    with pytest.raises(RuntimeError, match="no span"):
        _read("host_syncs_per_call.rollout", reduce(EVENTS[1:3]))


def test_a_program_without_spans_reports_nothing():
    assert _read("qp_solve_idle_ms_per_window", None) is None
    assert _read("host_syncs_per_call.gusto", None) is None
    assert reduce([e for e in EVENTS if e.kind != "span"]).calls == 0


def test_the_span_pass_outside_a_run_raises():
    with pytest.raises(RuntimeError, match="run_cell"):
        spans.of(SimpleNamespace())


def test_a_cpu_profile_gives_spans_and_host_operations():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from soft_robot_control_tpu_torch.utils.timing import span
    from soft_robot_control_tpu_torch.utils.timing import spans as on

    with on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer.a"), span("inner.b"):
            torch.ones(3).sum()
    ev = spans._events(prof)
    assert {e.name for e in ev if e.kind == "span"} == {"outer.a", "inner.b"}
    assert any(e.kind == "op" and e.name == "aten::sum" for e in ev)
    got = [(s.name, s.parent, s.call) for s in reduce(ev).spans]
    assert got == [("outer.a", -1, 0), ("inner.b", 0, 0)]
