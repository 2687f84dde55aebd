"""The span pass of a `--trace 1` run and its reduction.

`SPAN_CALLS` calls of the timed path run with the program's spans on
(`soft_robot_control_tpu_torch.utils.timing.span`), under a profiler that
records the host and the device on one clock. From its raw events
(`kineto_results.events()`, as harness/trace.py reads them) come:

- spans: the program's ranges (the host's user annotations; the device's
  copies of them are dropped), each with its parent, the innermost span
  around it on its thread, and its call, the ordinal of its root span;
- device operations, each put down to the innermost span around the host
  runtime call that launched it (the two share a correlation id);
- idle gaps: the stretches of the calls' window (the first root span's
  start to the last one's end) in which no device operation ran, each put
  down to the innermost span around its midpoint, or to `between calls`
  outside every root span;
- host synchronisations: runtime calls inside a root span that wait for
  the device (a synchronising call, a blocking copy, a copy to the host),
  one for each outermost host operation under the innermost span around
  them; the harness's own sync after a call lies outside every root span.

The pass runs after harness/trace.py's two passes, which run with spans
off, and first times calls with spans off and on in turns, the profiler
idle: the cost of spans. Against a program without spans (no `spans` in
its utils/timing.py) it runs nothing and the span metrics are left out.
"""

from __future__ import annotations

import statistics
import sys
import time
from dataclasses import dataclass, field

SPAN_CALLS = 3      # calls profiled with spans on
COST_PAIRS = 10     # calls timed with spans off and on, the profiler idle
BETWEEN = "between calls"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
# the spans of a QP's build and of the ticks (PERF.md section 3)
QP_BUILD = ("qp.assemble", "qp.ruiz", "qp.kinv", "qp.rho", "qp.recover",
            "ekf.correct", "mpc.tick")


@dataclass(frozen=True)
class Event:
    kind: str       # "span", "op" (host), "runtime" (CUDA API), "device"
    name: str
    start: int      # ns, one clock for the host and the device
    end: int
    corr: int = 0   # a runtime call and what it launched share it
    thread: int = 0


@dataclass
class Span:
    name: str
    start: int
    end: int
    parent: int     # index in Spans.spans, -1 for a root
    call: int       # ordinal of the root span


@dataclass
class Spans:
    spans: list                                  # [Span] by start
    device: list = field(default_factory=list)   # [(ns, span, launched)]
    gaps: list = field(default_factory=list)     # [(ns, span)]
    syncs: list = field(default_factory=list)    # [(span, operation)]

    @property
    def calls(self) -> int:
        return sum(s.parent < 0 for s in self.spans)

    def label(self, i: int) -> str:
        return self.spans[i].name if i >= 0 else BETWEEN

    def count(self, name: str) -> int:
        return sum(s.name == name for s in self.spans)

    def require(self, names):
        """Raises unless the pass saw a span of one of `names`."""
        if not any(self.count(n) for n in names):
            raise RuntimeError(f"no span {' or '.join(names)} in the span "
                               "pass")

    def idle_ms(self, names) -> float:
        """Idle ms put down to one of `names` (BETWEEN: outside calls)."""
        return 1e-6 * sum(ns for ns, i in self.gaps if self.label(i) in names)

    def device_ms(self, names) -> float:
        """Device ms of the operations launched inside one of `names`."""
        return 1e-6 * sum(ns for ns, i, _ in self.device
                          if self.label(i) in names)

    def syncs_by_call(self) -> list:
        out = [0] * self.calls
        for i, _ in self.syncs:
            out[self.spans[i].call] += 1
        return out

    def table(self) -> list:
        """[name, count, host self ms, device ms, idle ms, syncs] a call for
        each span name in order of first use, then BETWEEN."""
        rows = {}
        for s in self.spans:
            row = rows.setdefault(s.name, [0, 0, 0, 0, 0])
            row[0] += 1
            row[1] += s.end - s.start
            if s.parent >= 0:
                rows[self.spans[s.parent].name][1] -= s.end - s.start
        rows[BETWEEN] = [0, 0, 0, 0, 0]
        for ns, i, _ in self.device:
            rows[self.label(i)][2] += ns
        for ns, i in self.gaps:
            rows[self.label(i)][3] += ns
        for i, _ in self.syncs:
            rows[self.label(i)][4] += 1
        n = max(self.calls, 1)
        return [[k, c / n, 1e-6 * h / n, 1e-6 * d / n, 1e-6 * g / n, y / n]
                for k, (c, h, d, g, y) in rows.items()]


def _stacks(ranges, times):
    """For each instant of `times`, the indices of the host ranges (sorted
    by start, outer first, nested as calls nest) that cover it, outermost
    first."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [()] * len(times)
    stack, j = [], 0
    for k in order:
        t = times[k]
        while j < len(ranges) and ranges[j].start <= t:
            while stack and ranges[stack[-1]].end <= ranges[j].start:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and ranges[stack[-1]].end < t:
            stack.pop()
        out[k] = tuple(stack)
    return out


def _waits(rt, copies) -> bool:
    """Whether the runtime call `rt` waits for the device: `copies` maps
    a correlation id to the name of the device copy it launched."""
    if rt.name in SYNC_CALLS:
        return True
    if rt.name.startswith("cudaMemcpy"):
        return "Async" not in rt.name or "DtoH" in copies.get(rt.corr, "")
    return False


def reduce(events) -> Spans:
    """The spans, device operations, idle gaps and host synchronisations
    of a profile's events ([Event])."""
    outer_first = lambda e: (e.start, -e.end)
    marks = sorted((e for e in events if e.kind == "span"), key=outer_first)
    if not marks:
        return Spans([])
    thread = marks[0].thread
    marks = [m for m in marks if m.thread == thread]
    # a span's parent: the innermost span that holds it
    spans, stack, index, roots = [], [], {}, 0
    for m in marks:
        while stack and spans[stack[-1]].end < m.end:
            stack.pop()
        parent = stack[-1] if stack else -1
        call = spans[parent].call if stack else roots
        roots += not stack
        index[id(m)] = len(spans)
        stack.append(len(spans))
        spans.append(Span(m.name, m.start, m.end, parent, call))
    host = sorted(marks + [e for e in events if e.kind == "op"
                           and e.thread == thread], key=outer_first)

    def inner(stack):
        """(innermost span, the outermost host operation under it)."""
        at = [p for p, j in enumerate(stack) if id(host[j]) in index]
        if not at:
            return -1, None
        ops = stack[at[-1] + 1:]
        return (index[id(host[stack[at[-1]]])],
                host[ops[0]] if ops else None)

    # runtime calls carry the profiler's thread ids, not the host ranges'
    runtime = [e for e in events if e.kind == "runtime"]
    device = sorted((e for e in events if e.kind == "device"
                     and e.name not in {s.name for s in spans}),
                    key=lambda e: e.start)
    where = [inner(st) for st in _stacks(
        host, [(r.start + r.end) // 2 for r in runtime])]
    by_corr = {r.corr: w[0] for r, w in zip(runtime, where) if r.corr}
    out = Spans(spans)
    for d in device:
        i = by_corr.get(d.corr, -1)
        out.device.append((d.end - d.start, i, d.corr in by_corr))

    # idle gaps over the calls' window
    roots = [s for s in spans if s.parent < 0]
    t0, t1 = roots[0].start, max(s.end for s in roots)
    gaps, cur = [], t0
    for d in device:
        if d.start > cur and cur < t1:
            gaps.append((cur, min(d.start, t1)))
        cur = max(cur, d.end)
    if cur < t1:
        gaps.append((cur, t1))
    mids = _stacks(host, [(a + b) // 2 for a, b in gaps])
    out.gaps = [(b - a, inner(st)[0]) for (a, b), st in zip(gaps, mids)]

    # host synchronisations, one an outermost host operation in a span
    copies = {d.corr: d.name for d in device if d.name.startswith("Memcpy")}
    seen = set()
    for r, (i, op) in zip(runtime, where):
        if i < 0 or not _waits(r, copies):
            continue
        key = (i, op.start if op is not None else ("runtime", r.start))
        if key in seen:
            continue
        seen.add(key)
        name = (op.name if op is not None else "(no operation)")
        out.syncs.append((i, f"{name}: {r.name}"))
    return out


def _events(prof) -> list:
    """[Event] of a profile of the host and the device."""
    from torch.autograd import DeviceType

    from port_bench.harness.trace import _runtime

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_hidden_event() or e.end_ns() < e.start_ns():
            continue
        cuda = e.device_type() == DeviceType.CUDA
        if e.is_user_annotation():
            if cuda:
                continue            # the device's copy of a span
            kind = "span"
        elif cuda:
            if e.end_ns() == e.start_ns():
                continue
            kind = "device"
        else:
            kind = "runtime" if _runtime(e.name()) else "op"
        out.append(Event(kind, e.name(), e.start_ns(), e.end_ns(),
                         e.correlation_id(), e.start_thread_id()))
    return out


def cost(call, sync, spans, pairs: int = COST_PAIRS):
    """Seconds of `pairs` calls with spans off and of the same calls with
    spans on, in turns, the profiler idle: ([off], [on])."""
    t = {False: [], True: []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            with spans(on):
                t0 = time.perf_counter()
                sync(call(i))
                t[on].append(time.perf_counter() - t0)
    return t[False], t[True]


def run(call, sync, n_calls: int = SPAN_CALLS, out=sys.stderr):
    """The span pass over `n_calls` calls (Spans), or None for a program
    without spans."""
    try:
        from soft_robot_control_tpu_torch.utils.timing import spans
    except ImportError:
        print("port_bench: no span pass: the program has no spans", file=out)
        return None
    from torch.profiler import ProfilerActivity, profile

    off, on = cost(call, sync, spans)
    mo, mn = statistics.median(off), statistics.median(on)
    print(f"port_bench: spans' cost: a call {1e3 * mo:.3f} ms with spans off, "
          f"{1e3 * mn:.3f} ms on ({100 * (mn / mo - 1):+.2f}%), medians of "
          f"{len(off)} calls each in turns, the profiler idle", file=out)
    with spans(), profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
        for i in range(n_calls):
            sync(call(i))
    sp = reduce(_events(prof))
    report(sp, out)
    return sp


def report(sp: Spans, out=sys.stderr):
    """The table of spans a call, the coverage and where each host
    synchronisation comes from, on `out`."""
    print(f"port_bench: span pass, {sp.calls} calls; a call: span, count, "
          "host self ms, device ms launched, idle ms, syncs", file=out)
    for name, *vals in sp.table():
        print(f"  {name:<16}" + "".join(f" {v:10.3f}" for v in vals),
              file=out)
    dev = sum(ns for ns, _, _ in sp.device)
    launched = sum(ns for ns, i, ok in sp.device if ok and i >= 0)
    idle = sum(ns for ns, _ in sp.gaps)
    named = sum(ns for ns, i in sp.gaps if i >= 0)
    print(f"port_bench: device time put down to a span through its launch "
          f"{launched / max(dev, 1):.4%} of {1e-6 * dev:.3f} ms; idle "
          f"{1e-6 * idle:.3f} ms, in a span {named / max(idle, 1):.4%}, "
          f"between calls the rest", file=out)
    counts = {}
    for i, op in sp.syncs:
        counts[(sp.label(i), op)] = counts.get((sp.label(i), op), 0) + 1
    print(f"port_bench: host syncs by call {sp.syncs_by_call()}", file=out)
    for (name, op), k in sorted(counts.items(), key=lambda kv: -kv[1]):
        print(f"  {k / max(sp.calls, 1):g} a call in {name}: {op}", file=out)


def per_window(ctx, names, quantity: str = "idle_ms"):
    """`Spans.idle_ms` (or `device_ms`) of `names` over the pass's batched
    MPC windows, or None for a program without spans."""
    sp = of(ctx)
    if sp is None:
        return None
    sp.require(names)
    sp.require(("mpc.window",))
    return getattr(sp, quantity)(names) / sp.count("mpc.window")


_NOT_RUN = object()


def of(ctx):
    """The span pass of the run whose metrics `ctx` holds, made on first use
    and kept on it as `spans`; None for a program without spans.

    harness/cli.py's run_cell reads the per-layer metrics in
    BENCHMARK.json's order, the span metrics after the device-trace ones, so
    the pass runs after the two passes of harness/trace.py. The calls and
    their sync come from run_cell's frame (its `drv`, `sync` and `n0`):
    run_cell hands the metrics only the Context."""
    sp = getattr(ctx, "spans", _NOT_RUN)
    if sp is _NOT_RUN:
        call, sync = _timed_path()
        ctx.spans = sp = run(call, sync)
        if sp is not None and sp.calls:
            roots = [s for s in sp.spans if s.parent < 0]
            idle = sum(ns for ns, _ in sp.gaps)
            window = max(s.end for s in roots) - roots[0].start
            print(f"port_bench: idle share {idle / window:.4f} in the span "
                  f"pass, {1 - ctx.trace.busy_s / ctx.trace.window_s:.4f} "
                  "in the device-only pass", file=sys.stderr)
    return sp


def _timed_path():
    from port_bench.harness import cli

    f = sys._getframe(1)
    while f is not None and f.f_code is not cli.run_cell.__code__:
        f = f.f_back
    if f is None:
        raise RuntimeError("the span pass runs inside harness/cli.py's "
                           "run_cell, which is not running")
    drv, sync = f.f_locals["drv"], f.f_locals["sync"]
    first = f.f_locals["n0"] + cli.TRACE_CALLS + cli.GAP_CALLS
    return (lambda j: drv.call(first + j)), sync
