"""Timing and profiling utilities.

The reference times with ad-hoc time.time() deltas and accumulates OSQP
solve times (SURVEY.md section 5). Here, as in the JAX package:
- `Timer`: an accumulating wall-clock timer with min/mean/max statistics;
- `trace(log_dir)`: a torch.profiler trace of the host and, where there is
  a card, the device, written to log_dir (TensorBoard / Perfetto);
- `block_time(fn, *args)`: wall seconds of one call until the devices that
  hold its output have finished the work queued on them;
- `span(name)`: a named range of the program's own layers (an MPC window,
  a GuSTO iteration, a K^-1 build) in the profiler's timeline, beside the
  device operations it launched and on their clock. Spans are off unless
  `spans()` or `trace()` turns them on; off, a span costs one test of a
  flag and touches neither torch nor the device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import torch


class Timer:
    def __init__(self):
        self.samples = defaultdict(list)
        self._start = {}

    def start(self, name: str):
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._start.pop(name)
        self.samples[name].append(dt)
        return dt

    @contextlib.contextmanager
    def section(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def stats(self, name: Optional[str] = None) -> dict:
        names = [name] if name else list(self.samples)
        out = {}
        for n in names:
            s = self.samples[n]
            if not s:
                continue
            out[n] = {"min": min(s), "mean": sum(s) / len(s), "max": max(s),
                      "count": len(s), "total": sum(s)}
        return out[name] if name else out


_spans_on = False
_OFF = contextlib.nullcontext()  # the one context every span gives when off


def span(name: str):
    """A context manager that marks its body as the span `name`: with spans
    on, a `torch.profiler.record_function` range, whose parent in the
    timeline is the innermost span around it on the same thread; with
    spans off, a shared context that does nothing."""
    if not _spans_on:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spans(on: bool = True):
    """Turn spans on (or off) for the body; the previous state comes back
    on exit."""
    global _spans_on
    prev, _spans_on = _spans_on, bool(on)
    try:
        yield
    finally:
        _spans_on = prev


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace (host, and the card's kernels where
    CUDA is available) into log_dir as a TensorBoard trace file, with the
    program's spans on: its layers show beside the kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    with spans():
        prof.start()
        try:
            yield prof
        finally:
            prof.stop()


def _devices(out, found):
    """The CUDA devices of the tensors in out (through dicts, lists and
    tuples) into the set found."""
    if torch.is_tensor(out):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


def block_time(fn, *args, **kwargs) -> float:
    """Wall seconds of fn(*args, **kwargs), until every CUDA device that
    holds a tensor of its output has finished its queued work (the role of
    jax.block_until_ready)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _devices(out, set()):
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0
