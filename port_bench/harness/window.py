"""The measured window: one caller in a closed loop, each batch call
dispatched only after the last one's outputs were synchronised, until the
window's seconds have passed. A sample of the calls' outputs, drawn from
the seed (reservoir sampling over the calls that completed), is kept for
the correctness check."""

from __future__ import annotations

import random
import statistics
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    seconds: float                 # opening of the first call to the end
    latencies: list                # s of each call, dispatch to sync
    kept: list                     # [(call index, outputs)]
    finite: list = field(default_factory=list)  # device flags, one a call

    @property
    def calls(self) -> int:
        return len(self.latencies)


def run_window(call, sync, finite, seconds: float, keep: int,
               seed: int) -> Window:
    """Calls `call(i)` in a closed loop for `seconds` seconds (the last call
    ends past the deadline), timing each from dispatch to its synchronised
    outputs, and keeps `keep` of the outputs drawn from `seed`."""
    rng = random.Random(seed)
    kept, lat, flags = [], [], []
    t_open = time.perf_counter()
    deadline = t_open + seconds
    i, t_end = 0, t_open
    while t_end < deadline:
        t0 = time.perf_counter()
        out = call(i)
        flags.append(finite(out))
        sync(out)
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        if len(kept) < keep:
            kept.append((i, out))
        else:
            j = rng.randrange(i + 1)
            if j < keep:
                kept[j] = (i, out)
        i += 1
    return Window(t_end - t_open, lat, kept, flags)


MIN_TAIL_SAMPLES = 20   # a 95th percentile needs one sample beyond it


def p95(values) -> float:
    """The 95th percentile (Python's default, exclusive method)."""
    if len(values) < MIN_TAIL_SAMPLES:
        raise ValueError(f"a 95th percentile needs at least "
                         f"{MIN_TAIL_SAMPLES} samples, got {len(values)}")
    return statistics.quantiles(values, n=20)[-1]
