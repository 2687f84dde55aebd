"""The campaign gates of the port (soft_robot_control_tpu_torch/examples/
campaign_gates.py) against the JAX gate tests they port
(tests/test_campaign_artifacts.py, tests/test_trunk_campaign_artifacts.py),
and the dictionary pruner's twin against tools/prune_tpwl_dict.py.

Each gate passes on the committed examples/diamond_tet/ and
examples/trunk_tet/ artifacts, as its JAX test does there (the suite runs
those). On a copy with one
field pushed just past a limit, the port's gate fails, and so does the JAX
test pointed at the copy (its module's ART_DIR monkeypatched). The copies
link the committed files they do not change."""

import json
import os
import pickle

import numpy as np
import pytest

import test_campaign_artifacts as jdiamond
import test_trunk_campaign_artifacts as jtrunk
from torch_helpers import REPO

from soft_robot_control_tpu_torch.examples import campaign_gates as G
from soft_robot_control_tpu_torch.tools import prune_tpwl_dict

DIAMOND = os.path.join(REPO, "examples", "diamond_tet")
TRUNK = os.path.join(REPO, "examples", "trunk_tet")

# (port gate, JAX test, its module, the JAX test's argument)
PAIRS = {
    "pod_layout": (G.campaign_pod_layout, "test_campaign_pod_layout",
                   jdiamond, None),
    "dictionary": (G.campaign_tpwl_dict_discrete_native,
                   "test_campaign_tpwl_dict_discrete_native", jdiamond, None),
    "rest": (G.campaign_rest_matches_pod_ref,
             "test_campaign_rest_matches_pod_ref", jdiamond, None),
    "ssm": (G.diamond_ssm_artifact_stable_and_tracks,
            "test_diamond_ssm_artifact_stable_and_tracks", jdiamond, None),
    "tpwl_loop": (G.diamond_tpwl_gusto_closed_loop_gates,
                  "test_diamond_tpwl_gusto_closed_loop_gates", jdiamond,
                  None),
    "baselines": (G.diamond_baselines_gates, "test_diamond_baselines_gates",
                  jdiamond, None),
    "realtime": (G.realtime_latency_gates, "test_realtime_latency_gates",
                 jdiamond, None),
    "noisy": (G.noisy_batch_mpc_gates, "test_noisy_batch_mpc_gates",
              jdiamond, None),
    "trunk_quality": (G.trunk_campaign_quality_gates,
                      "test_trunk_campaign_quality_gates", jtrunk, None),
    "trunk_scp_sim": (lambda d: G.trunk_campaign_sims_loadable(
        d, "scp_fig8_sim.pkl"), "test_trunk_campaign_sims_loadable", jtrunk,
        "scp_fig8_sim.pkl"),
    "trunk_ilqr_sim": (lambda d: G.trunk_campaign_sims_loadable(
        d, "ilqr_fig8_sim.pkl"), "test_trunk_campaign_sims_loadable", jtrunk,
        "ilqr_fig8_sim.pkl"),
    "trunk_dictionary": (G.trunk_tpwl_dictionary_loads_discrete,
                         "test_trunk_tpwl_dictionary_loads_discrete", jtrunk,
                         None),
    "trunk_ssm": (G.trunk_ssm_mpc_gates, "test_trunk_ssm_mpc_gates", jtrunk,
                  None),
}


def _jax_test(name, monkeypatch, art_dir):
    gate, test, mod, arg = PAIRS[name]
    monkeypatch.setattr(mod, "ART_DIR", art_dir)
    fn = getattr(mod, test)
    return lambda: fn(arg) if arg is not None else fn()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_gate_passes_the_committed_artifacts_as_jax(name):
    """Each port gate passes on the committed artifacts, as its JAX test
    does there (the suite runs those tests on the same files:
    tests/test_campaign_artifacts.py and
    tests/test_trunk_campaign_artifacts.py)."""
    gate, _, mod, _ = PAIRS[name]
    gate(DIAMOND if mod is jdiamond else TRUNK)


# pushes: (gate, file, how); each edits one field of one artifact just
# past its limit
def _json_set(*path_value):
    def edit(r):
        *keys, value = path_value
        node = r
        for k in keys[:-1]:
            node = node[k]
        if value is KeyError:
            del node[keys[-1]]
        else:
            node[keys[-1]] = value
        return r
    return edit


def _pod_columns(n):
    def edit(d):
        d["POD_info"]["U"] = np.asarray(d["POD_info"]["U"])[:, :n]
        return d
    return edit


def _pod_skew(d):
    U = np.array(d["POD_info"]["U"], dtype=np.float64)
    U[:, 0] *= 1.0 + 3e-4
    d["POD_info"]["U"] = U
    return d


def _pod_rows(d):
    info = d["POD_info"]
    for k in ("U", "q_ref", "v_ref"):
        info[k] = np.asarray(info[k])[:-3]
    return d


def _points(n):
    def edit(d):
        for k in ("q", "v", "u", "A_c", "B_c", "d_c", "A_d", "B_d", "d_d"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k])[:n]
        return d
    return edit


def _dt(d):
    d["dt"] = 0.02
    return d


def _rest(d):
    d["rest"] = np.asarray(d["rest"]) + 2e-5
    return d


def _sim_nan(d):
    z = np.array(d["z"], dtype=np.float64)
    z[3, 1] = np.nan
    d["z"] = z
    return d


def _sim_still(d):
    z = np.array(d["z"], dtype=np.float64)
    z[:, 0] = z[0, 0] + np.linspace(0.0, 10.0, len(z))
    d["z"] = z
    return d


PUSHES = {
    "pod_rom_dim": ("pod_layout", "pod_model.pkl", _pod_columns(19)),
    "pod_orthonormal": ("pod_layout", "pod_model.pkl", _pod_skew),
    "pod_full_dim": ("pod_layout", "pod_model.pkl", _pod_rows),
    "dictionary_points": ("dictionary", "tpwl_model_snapshots.pkl",
                          _points(199)),
    "dictionary_dt": ("dictionary", "tpwl_model_snapshots.pkl", _dt),
    "rest": ("rest", "rest.pkl", _rest),
    "ssm_rmse": ("ssm", "diamond_ssm_mpc.json",
                 _json_set("tracking_rmse_mm", 5.0)),
    "ssm_held_out": ("ssm", "diamond_ssm_mpc.json",
                     _json_set("held_out_rel", 0.2)),
    "tpwl_rmse": ("tpwl_loop", "diamond_tpwl_campaign.json",
                  _json_set("scp_rmse_mm", 10.0)),
    "tpwl_solve": ("tpwl_loop", "diamond_tpwl_campaign.json",
                   _json_set("scp_solve_ms_mean", 300.0)),
    "tpwl_budget": ("tpwl_loop", "diamond_tpwl_campaign.json",
                    _json_set("mpc_replan_budget_ms", KeyError)),
    "rompc_rmse": ("baselines", "diamond_baselines.json",
                   _json_set("rompc", "tracking_rmse_mm", 5.0)),
    "koopman_rmse": ("baselines", "diamond_baselines.json",
                     _json_set("koopman", "tracking_rmse_mm", 10.0)),
    "rompc_solve": ("baselines", "diamond_baselines.json",
                    _json_set("rompc", "solve_ms_mean", 100.0)),
    "koopman_solve": ("baselines", "diamond_baselines.json",
                      _json_set("koopman", "solve_ms_mean", 100.0)),
    "realtime_mean": ("realtime", "realtime_mpc.json",
                      _json_set("compute_ms_mean", 20.0)),
    "realtime_p99": ("realtime", "realtime_mpc.json",
                     _json_set("compute_ms_p99", 40.0)),
    "noisy_clean": ("noisy", "noisy_batch_mpc.json",
                    _json_set("noise", "0.0", 0.0501)),
    "trunk_scp_rmse": ("trunk_quality", "trunk_tpwl_campaign.json",
                       _json_set("scp_rmse_mm", 18.0)),
    "trunk_ilqr_rmse": ("trunk_quality", "trunk_tpwl_campaign.json",
                        _json_set("ilqr_rmse_mm", 14.0)),
    "trunk_rejects": ("trunk_quality", "trunk_tpwl_campaign.json",
                      _json_set("scp_plan_rejects", 51)),
    "trunk_span_x": ("trunk_quality", "trunk_tpwl_campaign.json",
                     _json_set("scp_tip_span_mm", 0, 40.0)),
    "trunk_span_y": ("trunk_quality", "trunk_tpwl_campaign.json",
                     _json_set("scp_tip_span_mm", 1, 40.0)),
    "trunk_span_z": ("trunk_quality", "trunk_tpwl_campaign.json",
                     _json_set("scp_tip_span_mm", 2, 25.0)),
    "trunk_solve": ("trunk_quality", "trunk_tpwl_campaign.json",
                    _json_set("scp_solve_ms_mean", 300.0)),
    "trunk_budget": ("trunk_quality", "trunk_tpwl_campaign.json",
                     _json_set("mpc_replan_budget_ms", KeyError)),
    "trunk_scp_sim_finite": ("trunk_scp_sim", "scp_fig8_sim.pkl", _sim_nan),
    "trunk_ilqr_sim_sweep": ("trunk_ilqr_sim", "ilqr_fig8_sim.pkl",
                             _sim_still),
    "trunk_dictionary_points": ("trunk_dictionary",
                                "tpwl_model_snapshots.pkl", _points(99)),
    "trunk_ssm_rmse": ("trunk_ssm", "trunk_ssm_mpc.json",
                       _json_set("tracking_rmse_mm", 8.0)),
    "trunk_ssm_envelope": ("trunk_ssm", "trunk_ssm_mpc.json",
                           _json_set("u_envelope_mN", 300.5)),
}


def _pushed_copy(src, dst, name, edit):
    """dst: src's files linked, `name` written again with edit applied."""
    os.makedirs(dst)
    for f in os.listdir(src):
        if f != name:
            os.symlink(os.path.join(src, f), os.path.join(dst, f))
    path = os.path.join(src, name)
    if name.endswith(".json"):
        with open(path) as f:
            data = edit(json.load(f))
        with open(os.path.join(dst, name), "w") as f:
            json.dump(data, f)
    else:
        with open(path, "rb") as f:
            data = edit(pickle.load(f))
        with open(os.path.join(dst, name), "wb") as f:
            pickle.dump(data, f)


@pytest.mark.parametrize("push", sorted(PUSHES))
def test_gate_fails_a_pushed_copy_as_jax(push, tmp_path, monkeypatch):
    name, artifact, edit = PUSHES[push]
    gate, _, mod, _ = PAIRS[name]
    src = DIAMOND if mod is jdiamond else TRUNK
    d = str(tmp_path / "copy")
    _pushed_copy(src, d, artifact, edit)
    with pytest.raises(AssertionError):
        gate(d)
    with pytest.raises(AssertionError):
        _jax_test(name, monkeypatch, d)()


def test_runners_read_the_run_directory(tmp_path):
    """diamond_gates / trunk_gates: the gates of a file (or those -k
    selects) on the committed directory hold; an empty directory holds
    (each gate's artifact is absent); a pushed copy fails by its gate's
    name."""
    assert G.trunk_gates(TRUNK) == []
    assert G.diamond_gates(str(tmp_path)) == G.trunk_gates(
        str(tmp_path)) == []
    d = str(tmp_path / "copy")
    _pushed_copy(TRUNK, d, "trunk_ssm_mpc.json",
                 _json_set("tracking_rmse_mm", 8.0))
    fails = G.trunk_gates(d)
    assert len(fails) == 1 and fails[0].startswith("trunk_ssm_mpc_gates")
    assert G.diamond_gates(DIAMOND, k="baselines") == []


def test_trunk_ssm_gate_judges_a_run_alone(tmp_path):
    """A Trunk SSM run writes trunk_ssm_mpc.json into a directory without
    the TPWL campaign's summary: the 8 mm and 300 mN limits still judge
    it (the JAX file would skip them there), and a run within them
    holds."""
    d = str(tmp_path / "ssm")
    os.makedirs(d)
    with open(os.path.join(TRUNK, "trunk_ssm_mpc.json")) as f:
        src = json.load(f)
    for field, value in (("tracking_rmse_mm", 8.0),
                         ("u_envelope_mN", 300.5)):
        with open(os.path.join(d, "trunk_ssm_mpc.json"), "w") as f:
            json.dump(dict(src, **{field: value}), f)
        fails = G.trunk_gates(d)
        assert len(fails) == 1 and fails[0].startswith(
            "trunk_ssm_mpc_gates"), (field, fails)
    with open(os.path.join(d, "trunk_ssm_mpc.json"), "w") as f:
        json.dump(src, f)
    assert G.trunk_gates(d) == []


def test_enforce_quarantines_a_failing_run(tmp_path):
    """enforce: on a failure the run's artifacts move to <out>/rejected/
    and GatesFailed (SystemExit 1) carries the failures and the summary."""
    d = str(tmp_path / "run")
    _pushed_copy(TRUNK, d, "trunk_ssm_mpc.json",
                 _json_set("tracking_rmse_mm", 8.0))
    art = os.path.join(d, "trunk_ssm_mpc.json")
    with pytest.raises(G.GatesFailed) as e:
        G.enforce(G.trunk_gates, d, [art], {"x": 1}, log=lambda s: None)
    assert e.value.code == 1 and e.value.summary == {"x": 1}
    assert not os.path.exists(art)
    assert os.path.exists(e.value.moved[art])
    G.enforce(G.trunk_gates, TRUNK, [], {}, log=lambda s: None)


@pytest.fixture(scope="module")
def trunk_dictionary():
    with open(os.path.join(TRUNK, "tpwl_model_snapshots.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("target", [1000, 600])
def test_pruner_keeps_the_jax_tools_points(trunk_dictionary, target):
    """On the committed Trunk dictionary (P=1450): the same kept indices
    and tau as tools/prune_tpwl_dict.py:prune, the pruned dictionary
    equal array for array, info equal."""
    import campaign_runs as C

    jtool = C.jax_script("prune_tpwl_dict", folder="tools")
    data = trunk_dictionary
    assert np.asarray(data["q"]).shape[0] == 1450
    jout, jkept, jtau = jtool.prune(data, target)
    tout, tkept, ttau = prune_tpwl_dict.prune(data, target)
    assert np.array_equal(tkept, jkept) and ttau == jtau
    assert abs(len(tkept) - target) <= max(1, int(0.05 * target))
    assert tout["info"] == jout["info"]
    for k in jout:
        if k != "info":
            C.same_arrays(jout[k], tout[k], 0.0, k)
