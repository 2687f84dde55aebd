"""Cells, configurations, traffic mixes, drivers and per-layer metrics,
found by name under the benchmark's folder."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str, what: str = "name") -> str:
    """`name` if it is a letter, digit or '_' followed by at most 63
    letters, digits, '_', '.' or '-'; raises otherwise."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"bad {what} {name!r}: a name is a letter, digit or "
                         "'_' and at most 63 more of letters, digits, '_', "
                         "'.', '-'")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ValueError(f"bad unit {unit!r}: 1 to 16 of letters, digits, "
                         "'_', '/', '%', '.', '-'")
    return unit


def _json(folder: str, name: str, what: str) -> dict:
    path = os.path.join(HERE, folder, check_name(name, what) + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {what} {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """workloads/<name>.json: {"config", "traffic", "limits"}."""
    c = _json("workloads", name, "cell")
    check_name(c["config"], "config")
    check_name(c["traffic"], "traffic")
    return c


def config(name: str) -> dict:
    return _json("configs", name, "config")


def traffic(name: str) -> dict:
    t = _json("traffic", name, "traffic")
    check_name(t["kind"], "traffic kind")
    return t


def _module(folder: str, name: str, what: str):
    path = os.path.join(HERE, folder, check_name(name, what) + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {what} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(kind: str):
    """entries/<kind>.py, the driver of a traffic kind."""
    return _module("entries", kind, "traffic kind")


def metric(name: str):
    """A per-layer metric's reader: metrics/<name>.py, or, for a name
    `<quantity>.<suffix>` without a file of its own, the quantity's reader
    (device_idle_share.mpc -> metrics/device_idle_share.py). The suffix
    only tells apart the cells whose end-to-end metric it moves."""
    stem = check_name(name, "metric")
    while not os.path.isfile(os.path.join(HERE, "metrics", stem + ".py")):
        if "." not in stem:
            raise FileNotFoundError(f"no metric {name!r} (metrics/"
                                    f"{name}.py or a reader of a prefix)")
        stem = stem.rsplit(".", 1)[0]
    return _module("metrics", stem, "metric")


def benchmark(root: str = ROOT):
    """BENCHMARK.json of the checkout, or None where there is none."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def per_layer_metrics(bench, cell_name: str):
    """[(name, unit)] of the per-layer metrics BENCHMARK.json gives this
    cell: those that list it, and those that list no cell."""
    out = []
    for m in (bench or {}).get("per_layer", []):
        if cell_name in m.get("workloads", [cell_name]):
            out.append((check_name(m["name"]), check_unit(m["unit"])))
    return out


def end_to_end_metrics(bench, cell_name: str):
    """Names of the end-to-end metrics BENCHMARK.json gives this cell, or
    None without a BENCHMARK.json."""
    if bench is None:
        return None
    return [m["name"] for m in bench.get("end_to_end", [])
            if cell_name in m.get("workloads", [cell_name])]


def check_program_sizes(model, cfg: dict):
    """Raises unless the program's model has the configuration's points,
    state size and cables."""
    got = (model.num_points, model.state_dim, model.input_dim)
    want = (cfg["points"], cfg["state_dim"], cfg["cables"])
    if got != want:
        raise ValueError(f"the program's model of {cfg['name']!r} has "
                         f"(points, state, cables) {got}, the "
                         f"configuration says {want}")
