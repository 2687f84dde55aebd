"""The readings a cell's limits are set from: the numbers of its check for
the program on many seeds (the lower readings) and for the control, the
reference in the next precision below the configuration's in the
program's place (the upper readings), at the cell's own size.

    python3 port_bench/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 101 102 103] [--device cuda]

Each seed makes its own input pool and runs the calls the check compares
(as many as a run keeps); one JSON line a seed, then a summary line with
the largest program reading and the smallest control reading of each
number. The benchmark's own runs do not run this.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                             "port_bench"):
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench.harness import registry  # noqa: E402


def readings(cell_name, seeds, program, device, overrides=None):
    """[(seed, {number: value})] of `program` ("port" or "control") on each
    seed, one driver built once."""
    cell = registry.cell(cell_name)
    cfg = registry.config(cell["config"])
    traffic = dict(registry.traffic(cell["traffic"]), **(overrides or {}))
    drv = registry.entry(traffic["kind"]).Driver(cfg, traffic, seeds[0],
                                                 torch.device(device),
                                                 program)
    drv.make_inputs(seeds[0])
    drv.build()
    keep = int(traffic["compare_calls"])
    out = []
    for seed in seeds:
        drv.make_inputs(seed)
        t0 = time.perf_counter()
        kept = [(i, drv.call(i)) for i in range(keep)]
        t1 = time.perf_counter()
        vals = drv.check(kept)
        t2 = time.perf_counter()
        print(json.dumps({"program": program, "seed": seed, **vals,
                          "calls_s": t1 - t0, "check_s": t2 - t1}),
              flush=True)
        out.append((seed, vals))
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lower = readings(args.workload, args.seeds, "port", args.device)
    summary = {"workload": args.workload,
               "lower": {k: max(v[k] for _, v in lower) for k in lower[0][1]}}
    if args.control_seeds:
        upper = readings(args.workload, args.control_seeds, "control",
                         args.device)
        summary["upper"] = {k: min(v[k] for _, v in upper)
                            for k in upper[0][1]}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
