"""The roofline yardstick against hand-worked counts, and the trace's
reduction on made-up events."""

import pytest

from port_bench.harness import roofline
from port_bench.harness.cli import Context
from port_bench.harness.trace import Trace


def test_admm_work_by_hand():
    # B=2 QPs, n=3, m=4, 5 iterations: 5 (2*9 + 4*12) = 330 flops a QP;
    # bytes: K^-1 9, A 12, q 3, l and u 8, warm start and solution 2 * 7,
    # a QP; rho 4 shared: 4 (2 * 46 + 4)
    assert roofline.admm_batched_work(2, 3, 4, 5) == (660.0, 384.0)


def test_select_work_by_hand():
    # S=2 states, rows for 1, P=3 points, r=2, n=2, m=1: a row is
    # 4 + 2 + 2 = 8 elements; 2 * 3 * 6 * 2 = 72 flops; bytes: states 2 * 4,
    # points 2 * 3 * 2, one row read and one written, 4 bytes each, and
    # 8-byte indices
    assert roofline.tpwl_select_work(2, 1, 3, 2, 2, 1) == (72.0, 160.0)
    # more rows than points: each point's row is read once at most
    f, b = roofline.tpwl_select_work(10, 10, 3, 2, 2, 1)
    assert b == 4 * (10 * 4 + 12 + (3 + 10) * 8) + 80


def test_least_time_takes_the_larger_bound():
    t = roofline.least_seconds(67e12, 0.0)
    assert t == pytest.approx(1.0)
    t = roofline.least_seconds(0.0, 3.35e12)
    assert t == pytest.approx(1.0)
    assert roofline.least_time([("admm_batched", (2, 3, 4, 5, 4))] * 2) == (
        pytest.approx(2 * max(660 / 67e12, 384 / 3.35e12)))


def _trace():
    ev = [("void admm_batched_reg_kernel<20, 40>(...)", 0, 100),
          ("void tpwl_select_kernel<float>(...)", 50, 150),
          ("Memcpy DtoH", 300, 400), ("volta_sgemm", 390, 500)]
    return Trace(ev, window_s=1e-6, calls=2)


def test_busy_time_is_the_union_of_intervals():
    tr = _trace()
    assert tr.busy_s == pytest.approx((150 + 200) / 1e9)
    assert tr.seconds_of(("tpwl_select_kernel",)) == (pytest.approx(1e-7), 1)
    assert tr.library() == (pytest.approx(210e-9), 2)
    assert tr.by_name(2)[0][1] == pytest.approx(1.1e-7)


def test_roofline_share_and_a_missing_kernel():
    launch = ("admm_batched", (2, 3, 4, 5, 4))
    ctx = Context(_trace(), [launch], work_per_call=8, steps_per_call=2)
    assert ctx.work == 16 and ctx.steps == 4 and len(ctx.launches) == 2
    want = 100 * 2 * roofline.least_seconds(660, 384) / 100e-9
    assert ctx.roofline_percent("admm_batched") == pytest.approx(want)
    with pytest.raises(RuntimeError):
        ctx.kernel_seconds("admm_stream")
