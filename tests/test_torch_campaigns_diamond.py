"""The Diamond TPWL and baselines campaign twins against the JAX scripts,
f64 on the CPU, on the small Diamond stand-in (tests/tet_standins.py:
DIAMOND_SMALL, 125 nodes, the scripts' node literals mapped onto it). The
stand-in is small because the JAX package's sweeps always run 500 plant
steps (`simulate_chunked` pads to its chunk), and one JAX TPWL run on the
1,584-node stand-in of chip_smoke.py took 947 s on an 8-core x86 CPU.

Both packages build the stand-in through one temporary plant cache, so
they run on the same plant arrays. The JAX scripts' enforce_gates is
stubbed (it runs pytest on the committed artifacts, not on the run); the
twins' gates run on their own --out, fail on the stand-in (they name the
1628-node mesh) and quarantine the run, whose files the tests copy back.

The scripts run with their own flags as short as they go: two LHS samples
of 0.05 s, 1.1 s loops (0.1 s after the 1 s delay; the baselines score
from 2 s, so their RMSEs are NaN in both packages and the loops are held
by their pickles), four Koopman samples (two and eight make a lifted
model whose first QP fails in the JAX script), and --rom-dim 8: the
snapshots of so short a run span 10 directions, and POD modes past them
are rounding noise that neither SVD fixes. Each basis column's sign is
free too; the port's artifacts are compared in the JAX basis' signs."""

import os

import pytest

import campaign_runs as C
from torch_helpers import REPO  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu_torch.examples import (diamond_baselines_campaign,
                                                   diamond_tet_campaign)

TPWL_FLAGS = ["--samples", "2", "--tpwl-samples", "2", "--t-step", "0.05",
              "--sim-duration", "1.1", "--rom-dim", "8"]
BASE_FLAGS = ["--sim-duration", "1.1", "--koopman-samples", "4"]
# Measured gaps (x86 CPU, f64): the collect stage's arrays within 1e-11 of
# their scale (the PCG steps stop after the same iterations, their sums
# run in other orders), the loop's z within 1.2e-11 and u within 1.6e-9
# (GuSTO's ADMM and the EKF carry the rounding), the summary's floats
# within 1.3e-10 (relative). The limits stand 100 times above them.
ARRAY_REL = 1e-9
LOOP_REL = 1e-7
SUMMARY_REL = 1e-8
# The Koopman loop: EDMD on four samples is ill-conditioned (ridge 1e-8),
# and the dense ADMM's adaptive rho and stopping carry the two least
# squares' rounding into the commands: measured 6.6e-6 of their scale at
# the second replan (z 2.6e-8)
KOOPMAN_REL = 1e-4
# wall-clock fields
CLOCKS = ("scp_solve_ms_mean", "solve_ms_mean")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("campaigns_diamond"))
    out = {"caches_before": C.real_plant_caches(), "root": root}
    j, t = os.path.join(root, "j"), os.path.join(root, "t")
    with C.campaign_standins(root):
        jt = C.jax_script("diamond_tet_campaign")
        C.run_jax(jt, ["--platform", "cpu", "--out", j] + TPWL_FLAGS)
        out["tpwl"] = C.run_port(diamond_tet_campaign,
                                 ["--device", "cpu", "--out", t] + TPWL_FLAGS)
        C.restore(out["tpwl"][2])   # the baselines read the dictionary
        jb = C.jax_script("diamond_baselines_campaign")
        C.run_jax(jb, ["--platform", "cpu", "--out", j] + BASE_FLAGS)
        out["base"] = C.run_port(diamond_baselines_campaign,
                                 ["--device", "cpu", "--out", t]
                                 + BASE_FLAGS)
        C.restore(out["base"][2])
        # a partial rerun of each twin: the loop again on the dictionary
        # in --out, the baselines scored again from their pickles
        out["tpwl_mpc"] = C.run_port(
            diamond_tet_campaign,
            ["--device", "cpu", "--out", t, "--skip-collect"] + TPWL_FLAGS)
        C.restore(out["tpwl_mpc"][2])
        C.run_jax(jb, ["--platform", "cpu", "--out", j, "--skip-rompc",
                       "--skip-koopman"] + BASE_FLAGS)
        out["base_rescored"] = C.run_port(
            diamond_baselines_campaign,
            ["--device", "cpu", "--out", t, "--skip-rompc",
             "--skip-koopman"] + BASE_FLAGS)
    out["caches_after"] = C.real_plant_caches()
    out["j"], out["t"] = j, t
    return out


def _jt(runs, name):
    return (C.load_pickle(os.path.join(runs["j"], name)),
            C.load_pickle(os.path.join(runs["t"], name)))


def test_tpwl_summary_is_the_jax_scripts(runs):
    """The same keys, integers (rom_dim, tpwl_points, scp_plan_rejects)
    and strings; floats within SUMMARY_REL; what main returned is what it
    wrote (the run's copy, restored from quarantine, holds the partial
    rerun's summary)."""
    summary = runs["tpwl"][0]
    ref = C.load_json(os.path.join(runs["j"], "diamond_tpwl_campaign.json"))
    assert ref["rom_dim"] == 8 and ref["tpwl_points"] >= 2
    C.same_summaries(summary, ref, SUMMARY_REL, skip=CLOCKS)
    assert C.load_json(os.path.join(
        runs["t"], "diamond_tpwl_campaign.json")) == runs["tpwl_mpc"][0]


def test_tpwl_artifacts_are_the_jax_scripts(runs):
    """Snapshots, rest, POD basis and dictionary array for array (the
    basis in the JAX columns' signs); the loop's pickle within LOOP_REL,
    its solve times by count."""
    for name in ("pod_snapshots.pkl", "rest.pkl"):
        C.same_arrays(*_jt(runs, name), ARRAY_REL, name)
    jp, tp = _jt(runs, "pod_model.pkl")
    s = C.pod_signs(jp["POD_info"]["U"], tp["POD_info"]["U"])
    C.same_arrays(jp, C.port_in_jax_signs(tp, s), ARRAY_REL, "pod")
    jd, td = _jt(runs, "tpwl_model_snapshots.pkl")
    C.same_arrays(jd, C.port_in_jax_signs(td, s), ARRAY_REL, "dictionary")
    js, ts = _jt(runs, "scp_fig8_sim.pkl")
    assert len(ts["info"].pop("solve_times")) == len(
        js["info"].pop("solve_times"))
    C.same_arrays(js, ts, LOOP_REL, "scp_fig8_sim")


def test_tpwl_partial_rerun_keeps_the_collect_fields(runs):
    """--skip-collect runs the loop again on the dictionary in --out: the
    collect stage's fields stay, the loop's are refreshed (the same
    numbers, so the JAX run's summary still holds)."""
    first, again = runs["tpwl"][0], runs["tpwl_mpc"][0]
    for k in ("rom_dim", "tpwl_points", "heldout_rel_err",
              "collect_platform"):
        assert again[k] == first[k]
    ref = C.load_json(os.path.join(runs["j"], "diamond_tpwl_campaign.json"))
    C.same_summaries(again, ref, SUMMARY_REL, skip=CLOCKS)


def test_tpwl_gates_fail_on_the_stand_in_and_quarantine(runs):
    """The Diamond gates read the run's --out: the POD layout gate names
    the 1628-node mesh, so the stand-in fails it; the summary, the loop's
    pickle, the basis and the dictionary went to <out>/rejected/."""
    _, fails, moved = runs["tpwl"]
    assert any(f.startswith("campaign_pod_layout") for f in fails), fails
    assert sorted(os.path.basename(p) for p in moved) == [
        "diamond_tpwl_campaign.json", "pod_model.pkl", "scp_fig8_sim.pkl",
        "tpwl_model_snapshots.pkl"]
    for dest in moved.values():
        assert os.path.dirname(dest) == os.path.join(runs["t"], "rejected")
        assert os.path.exists(dest)


def test_baselines_summary_is_the_jax_scripts(runs):
    """ROMPC and Koopman (dense, f64) on the dictionary each TPWL run
    wrote into its --out: the same keys and settings, the tracking RMSEs
    (NaN here) alike; the gate fails as the numbers say."""
    summary, fails, _ = runs["base"]
    ref = C.load_json(os.path.join(runs["j"], "diamond_baselines.json"))
    C.same_summaries(summary, ref, SUMMARY_REL, skip=CLOCKS)
    good = (summary["rompc"]["tracking_rmse_mm"] < 5.0
            and summary["koopman"]["tracking_rmse_mm"] < 10.0
            and all((summary[k]["solve_ms_mean"] or 0.0) < 100.0
                    for k in ("rompc", "koopman")))
    assert bool(fails) != good, fails


def test_baselines_artifacts_are_the_jax_scripts(runs):
    """rompc_sim.pkl within LOOP_REL, koopman_sim.pkl within KOOPMAN_REL,
    solve times by count."""
    for name, rel in (("rompc_sim.pkl", LOOP_REL),
                      ("koopman_sim.pkl", KOOPMAN_REL)):
        js, ts = _jt(runs, name)
        assert len(ts["info"].pop("solve_times")) == len(
            js["info"].pop("solve_times"))
        C.same_arrays(js, ts, rel, name)


def test_baselines_skipped_legs_are_scored_again(runs):
    """--skip-rompc --skip-koopman scores both legs again from their
    pickles: the first run's numbers."""
    first, again = runs["base"][0], runs["base_rescored"][0]
    for leg in ("rompc", "koopman"):
        C.same_summaries(again[leg], first[leg], 0.0)


def test_baselines_need_the_dictionary(tmp_path):
    """Without a dictionary in --out the twin stops as the JAX script."""
    with C.campaign_standins(str(tmp_path)):
        with pytest.raises(SystemExit, match="diamond_tet_campaign"):
            diamond_baselines_campaign.main(
                ["--device", "cpu", "--out", str(tmp_path / "empty")])


def test_stand_in_runs_leave_the_real_plant_caches_alone(runs):
    """Both packages built the stand-in into the temporary cache only."""
    assert runs["caches_after"] == runs["caches_before"]
    assert os.listdir(os.path.join(runs["root"], "plant_cache"))
