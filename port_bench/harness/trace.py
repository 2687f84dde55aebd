"""A profiler pass over a few calls of the timed path and its reduction:
device operations by name, the device's busy time (the union of the
operations' intervals), and the idle gaps between them, named by what the
host was doing in them.

The events are read raw from the profiler's results: `key_averages()`
builds an event tree on the host at some 0.2 ms a device operation.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

# The program's hand-written kernels by the names the profiler gives them
# (csrc/*.cu); every other device operation is a library's.
HAND_KERNELS = {
    "admm_batched": ("admm_batched_reg_kernel", "admm_block_kernel"),
    "admm_cluster": ("admm_cluster_kernel",),
    "admm_stream": ("admm_stream_kernel",),
    "admm_single": ("admm_single_kernel",),
    "tpwl_select": ("tpwl_select_kernel",),
}


def is_hand_kernel(name: str) -> bool:
    return any(k in name for ks in HAND_KERNELS.values() for k in ks)


@dataclass
class Trace:
    events: list                  # [(name, start_ns, end_ns)] on the device
    window_s: float               # host clock, first dispatch to last sync
    calls: int                    # calls of the timed path inside it
    gaps: list = field(default_factory=list)  # [(label, seconds)]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0, None
        for _, s, e in sorted(self.events, key=lambda ev: ev[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def seconds_of(self, names) -> tuple:
        """(seconds, count) of the device operations whose name contains
        one of `names`."""
        sel = [(s, e) for n, s, e in self.events
               if any(k in n for k in names)]
        return sum(e - s for s, e in sel) / 1e9, len(sel)

    def library(self) -> tuple:
        """(seconds, count) of the device operations that are not the
        program's hand kernels."""
        sel = [(s, e) for n, s, e in self.events if not is_hand_kernel(n)]
        return sum(e - s for s, e in sel) / 1e9, len(sel)

    def by_name(self, top: int = 10):
        out = {}
        for n, s, e in self.events:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return sorted(([n, t] for n, t in out.items()),
                      key=lambda kv: -kv[1])[:top]


def _device_events(prof):
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_hidden_event() and e.end_ns() > e.start_ns()]


def profile_calls(call, sync, n_calls: int) -> Trace:
    """`n_calls` closed-loop calls under a profiler that records the device
    alone."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_calls):
            sync(call(i))
        window = time.perf_counter() - t0
    return Trace(_device_events(prof), window, n_calls)


def idle_gaps(call, sync, n_calls: int, top: int = 10):
    """[(label, seconds)]: the device's idle time over `n_calls` calls under
    a profiler that records the host too, summed by the innermost host
    operation that covered the middle of each gap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_calls):
            sync(call(i))
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_hidden_event() or e.end_ns() <= e.start_ns():
            continue
        iv = (e.start_ns(), e.end_ns(), e.name())
        (dev if e.device_type() == DeviceType.CUDA else host).append(iv)
    dev.sort()
    # innermost first: of the host operations that cover an instant, the
    # one that started last (CUDA runtime calls name no layer: left out)
    host = sorted(iv for iv in host if not _runtime(iv[2]))
    starts = [s for s, _, _ in host]
    out, end = {}, None
    for s, e, _ in dev:
        if end is not None and s > end:
            mid = (end + s) // 2
            label = "host Python between operations"
            for j in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 4000),
                           -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            out[label] = out.get(label, 0.0) + (s - end) / 1e9
        end = e if end is None else max(end, e)
    return sorted(([k, v] for k, v in out.items()),
                  key=lambda kv: -kv[1])[:top]


def _runtime(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())
