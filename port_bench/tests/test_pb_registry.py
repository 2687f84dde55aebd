"""The benchmark is driven by data: every cell, configuration, traffic mix
and per-layer metric of BENCHMARK.json is a file found by its name, and the
names and units keep to the characters the contract allows."""

import json
import os

import pytest

from port_bench.harness import registry

BENCH = registry.benchmark()


def test_names_and_units_are_checked():
    for ok in ("diamond_mpc_fleet", "x.y-z_1", "_a", "9a", "a" * 64):
        assert registry.check_name(ok) == ok
    for bad in ("", "a b", "a,b", "a/b", "-a", ".a", "a" * 65, "μs",
                "a\tb"):
        with pytest.raises(ValueError):
            registry.check_name(bad)
    for ok in ("windows/s", "%", "ms", "ops/window", "share", "steps/s"):
        assert registry.check_unit(ok) == ok
    for bad in ("", "tokens per second", "a" * 17, "μs", "a,b"):
        with pytest.raises(ValueError):
            registry.check_unit(bad)


def test_a_bad_name_finds_no_file():
    with pytest.raises(ValueError):
        registry.cell("../BENCHMARK")
    with pytest.raises(FileNotFoundError):
        registry.cell("no_such_cell")
    with pytest.raises(FileNotFoundError):
        registry.metric("no_such_metric")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(w):
    cell = registry.cell(w["name"])
    assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
    traffic = registry.traffic(cell["traffic"])
    assert hasattr(registry.entry(traffic["kind"]), "Driver")
    assert set(cell["limits"]) and all(
        v >= 0 for v in cell["limits"].values())
    e2e = registry.end_to_end_metrics(BENCH, w["name"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.per_layer_metrics(BENCH, w["name"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_is_its_own_file(c):
    cfg = registry.config(c["name"])
    assert c["file"] == f"port_bench/configs/{c['name']}.json"
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert os.path.isfile(os.path.join(registry.ROOT, cfg["dictionary"]))


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(m):
    mod = registry.metric(m["name"])
    assert callable(mod.read)
    names = {e["name"] for e in BENCH["end_to_end"]}
    assert m["moves"] in names
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells
    for w in m["workloads"]:
        assert m["moves"] in registry.end_to_end_metrics(BENCH, w)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
        names.append(m["name"])
    for n in names:
        registry.check_name(n)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        registry.check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_setup_s_is_every_cells():
    """setup_s lists no cells, so a cell added later reports it too."""
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert "setup_s" in registry.end_to_end_metrics(BENCH, "a_later_cell")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_s_another_metric_and_a_layer(w):
    e2e = registry.end_to_end_metrics(BENCH, w["name"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.per_layer_metrics(BENCH, w["name"])


@pytest.mark.parametrize("name", ["device_idle_share.mpc",
                                  "device_idle_share.some_new_cell_kind",
                                  "tpwl_select_roofline.rollout"])
def test_a_suffixed_metric_takes_its_quantitys_reader(name):
    stem = name.split(".")[0]
    assert registry.metric(name).__name__.endswith(stem)


# -- a configuration may ask only for what the reference implements ------


def _traffic(kind):
    return {"mpc_fleet": registry.traffic("mpc_fleet_b4096"),
            "gusto_batch": registry.traffic("gusto_b256")}[kind]


@pytest.mark.parametrize("kind,group,key,value", [
    ("mpc_fleet", "mpc", "formulation", "sparse"),
    ("mpc_fleet", "mpc", "x_step", "solve"),
    ("mpc_fleet", "mpc", "warm_start", False),
    ("gusto_batch", "gusto", "formulation", "condensed"),
    ("gusto_batch", "gusto", "x_step", "solve"),
    ("gusto_batch", "gusto", "omega0", 10.0),
])
def test_a_setting_the_reference_lacks_is_refused(kind, group, key, value):
    cfg = registry.config("diamond_tpwl")
    cfg[group] = dict(cfg[group], **{key: value})
    with pytest.raises(ValueError, match=key):
        registry.entry(kind).Driver(cfg, _traffic(kind), 1, "cpu")


@pytest.mark.parametrize("kind", ["mpc_fleet", "gusto_batch"])
def test_the_committed_settings_are_accepted(kind):
    drv = registry.entry(kind).Driver(registry.config("diamond_tpwl"),
                                      _traffic(kind), 1, "cpu")
    assert drv.work_per_call > 0


def test_a_key_nothing_reads_is_refused():
    cfg = dict(registry.config("trunk_tpwl"), tf32=True)
    with pytest.raises(ValueError, match="tf32"):
        registry.entry("rollouts").Driver(
            cfg, registry.traffic("rollouts_b32768_t100"), 1, "cpu")


@pytest.mark.parametrize("key,value", [("points", 1086), ("cables", 8),
                                       ("state_dim", 58), ("num_nodes", 709)])
def test_sizes_are_checked_against_the_dictionary(key, value):
    from port_bench.reference.tpwl import read_raw

    cfg = dict(registry.config("diamond_tpwl"), **{key: value})
    with pytest.raises(ValueError, match="configuration"):
        read_raw(cfg, registry.ROOT)


def test_a_dt_other_than_the_dictionarys_is_refused():
    from port_bench.reference.tpwl import read_raw

    cfg = registry.config("diamond_tpwl")
    cfg["mpc"] = dict(cfg["mpc"], dt=0.02)
    with pytest.raises(ValueError, match="dt"):
        read_raw(cfg, registry.ROOT)
