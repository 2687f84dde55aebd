"""One run of one cell: set-up, the measured window, the traced pass with
`--trace 1`, the correctness check, and the result line."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

from port_bench.harness import registry
from port_bench.harness.guard import forbidden_modules
from port_bench.harness.roofline import least_time
from port_bench.harness.trace import HAND_KERNELS, idle_gaps, profile_calls
from port_bench.harness.window import p95, run_window

WARM_CALLS = 2      # set-up: every shape of the cell's traffic, twice
TRACE_CALLS = 3     # calls profiled for the per-layer metrics
GAP_CALLS = 1       # calls profiled with the host too, to name idle gaps
NAME_CHARS = 160    # of a device operation's name in the breakdown


class Context:
    """What a per-layer metric reads: the device trace of `trace.calls`
    calls, the hand kernels' launches those calls make by the problem's
    shapes, and the work they did."""

    def __init__(self, trace, launches_per_call, work_per_call,
                 steps_per_call):
        self.trace = trace
        self.launches = launches_per_call * trace.calls
        self.work = work_per_call * trace.calls     # windows or steps done
        self.steps = steps_per_call * trace.calls   # batched windows, steps

    def kernel_seconds(self, kernel: str) -> float:
        secs, count = self.trace.seconds_of(HAND_KERNELS[kernel])
        if count == 0:
            raise RuntimeError(f"no device operation of kernel {kernel!r} "
                               f"({HAND_KERNELS[kernel]}) in the trace")
        return secs

    def roofline_percent(self, kernel: str) -> float:
        least = least_time([ln for ln in self.launches if ln[0] == kernel])
        return 100.0 * least / self.kernel_seconds(kernel)


def sync_of(device):
    if device.type == "cuda":
        return lambda out: torch.cuda.synchronize(device)
    return lambda out: None


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None,
             bench=None, traffic_overrides=None, program="port"):
    """The result line (a dict) and the numbers of the check
    ({name: (value, limit)}) of one run of cell `name`."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = registry.cell(name)
    cfg = registry.config(cell["config"])
    traffic = dict(registry.traffic(cell["traffic"]),
                   **(traffic_overrides or {}))
    dev = torch.device(device)
    drv = registry.entry(traffic["kind"]).Driver(cfg, traffic, seed, dev,
                                                 program)
    sync = sync_of(dev)
    stages = [("start", time.perf_counter() - t_start)]
    drv.make_inputs(seed)
    stages.append(("inputs", time.perf_counter() - t_start))
    drv.build()
    stages.append(("program", time.perf_counter() - t_start))
    for i in range(WARM_CALLS):
        sync(drv.call(i))
    setup_s = time.perf_counter() - t_start
    stages.append(("warm calls", setup_s))
    print("port_bench: set-up " + ", ".join(
        f"{k} {b - a:.3f} s" for (_, a), (k, b) in
        zip([("", 0.0)] + stages, stages)), file=sys.stderr)

    win = run_window(drv.call, sync, drv.finite, seconds,
                     int(traffic["compare_calls"]), seed)
    attempted = win.calls
    failed = attempted - int(torch.stack(win.finite).sum()) if attempted else 0
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1}
    metric_name, unit = drv.throughput
    out = {}
    if not trace:
        out[metric_name] = {"value": drv.work_per_call * attempted
                            / win.seconds, "unit": unit}
        out["batch_ms_p95"] = {"value": 1e3 * p95(win.latencies),
                               "unit": "ms"}
        out["setup_s"] = {"value": setup_s, "unit": "s"}
        wanted = registry.end_to_end_metrics(bench, name)
        if wanted is not None:
            out = {k: v for k, v in out.items() if k in wanted}
        breakdown = None
    else:
        n0 = attempted + WARM_CALLS
        tr = profile_calls(lambda j: drv.call(n0 + j), sync, TRACE_CALLS)
        tr.gaps = idle_gaps(lambda j: drv.call(n0 + TRACE_CALLS + j), sync,
                            GAP_CALLS)
        ctx = Context(tr, drv.launches(), drv.work_per_call,
                      drv.steps_per_call)
        for mname, munit in registry.per_layer_metrics(bench, name):
            value = registry.metric(mname).read(ctx)
            if value is not None:
                out[mname] = {"value": value, "unit": munit}
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": [[n[:NAME_CHARS], t]
                                    for n, t in tr.by_name(10)],
                     "idle_gaps": tr.gaps}
    device_info["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)

    # the program's state goes before the reference runs on the card
    drv.release()
    kept = win.kept
    del win
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    values = drv.check(kept)
    limits = cell["limits"]
    if not set(limits) <= set(values):
        raise RuntimeError(f"cell {name}: the check gives {sorted(values)}, "
                           f"the limits name {sorted(limits)}")
    checks = {k: (values[k], float(limits[k])) for k in limits}
    correct = (attempted > 0 and failed == 0
               and all(math.isfinite(v) and v <= lim
                       for v, lim in checks.values()))
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": out, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return line, checks


def main(argv=None, t_start=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the port's "
                                 "benchmark once; prints one JSON line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")
    chips = 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(registry.ROOT, "build", "triton"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    bench = registry.benchmark()
    line, checks = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", t_start, bench)
    print(f"port_bench: card {power_limit()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
