"""The Trunk TPWL campaign twin and the dictionary pruner's twin against the
JAX scripts, f64 on the CPU, on the small Trunk stand-in
(tests/tet_standins.py: TRUNK_SMALL, 171 nodes).

The script runs with its own flags as short as they go: two LHS samples of
0.05 s at two amplitude scales, one figure-8 segment of 0.5 s (the default
segments are 40 s of data), a 5-step horizon, the slew-bounded second leg
(--dU-leg 25), 1.1 s loops, and --rom-dim 6: the snapshots of so short a
run leave the POD modes past the sixth close together, where neither SVD
fixes them, and each column's sign is free (the port's artifacts are
compared in the JAX basis' signs). The JAX script's enforce_gates is
stubbed; the twin's gates run on its --out and fail on the stand-in (the
dictionary gate names the 709-node mesh). The pruner then thins each run's
dictionary to 40 points with --check (the model-vs-model rollouts in
float32 on the stand-in robot)."""

import contextlib
import io
import os
import re

import numpy as np
import pytest

import campaign_runs as C
from torch_helpers import REPO  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu_torch.examples import trunk_tet_campaign
from soft_robot_control_tpu_torch.tools import prune_tpwl_dict

FLAGS = ["--samples", "2", "--tpwl-samples", "2", "--t-step", "0.05",
         "--amplitude-scale", "0.25,0.5", "--traj", "150:0.5",
         "--solver-N", "5", "--dU-leg", "25", "--sim-duration", "1.1",
         "--rom-dim", "6"]
# Measured gaps (x86 CPU, f64): the summary's floats within 1.9e-12
# (relative), the collect stage's arrays within 2.1e-11 of their scale
# (the dictionary's; the PCG steps sum in other orders) and the loops'
# pickles within 3.9e-13. The pruner's --check rollouts run in float32
# in both packages; their deviations are held within 1e-4 of each other.
SUMMARY_REL = 1e-8
ARRAY_REL = 1e-9
LOOP_REL = 1e-7
CHECK_ABS = 1e-4
CLOCKS = ("scp_solve_ms_mean", "solve_ms_mean")
PRUNE_FLAGS = ["--target", "40", "--check"]


def _rels(text):
    return [float(v) for v in re.findall(r"pruned-vs-full rel ([0-9.e+-]+)",
                                         text)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("campaigns_trunk"))
    j, t = os.path.join(root, "j"), os.path.join(root, "t")
    out = {"j": j, "t": t}
    with C.campaign_standins(root):
        jm = C.jax_script("trunk_tet_campaign")
        C.run_jax(jm, ["--platform", "cpu", "--out", j] + FLAGS)
        out["run"] = C.run_port(trunk_tet_campaign,
                                ["--device", "cpu", "--out", t] + FLAGS)
        C.restore(out["run"][2])
        # a partial rerun of the twin: the loops again on the dictionary
        # in --out
        out["rerun"] = C.run_port(trunk_tet_campaign,
                                  ["--device", "cpu", "--out", t,
                                   "--skip-collect", "--skip-ilqr"] + FLAGS)
        C.restore(out["rerun"][2])
        jp = C.jax_script("prune_tpwl_dict", folder="tools")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            C.run_jax(jp, ["--dict", os.path.join(j, "tpwl_model_snapshots"
                                                  ".pkl"),
                           "--out", os.path.join(j, "pruned.pkl")]
                      + PRUNE_FLAGS)
        out["jax_check"] = _rels(buf.getvalue())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["prune"] = prune_tpwl_dict.main(
                ["--dict", os.path.join(t, "tpwl_model_snapshots.pkl"),
                 "--out", os.path.join(t, "pruned.pkl"), "--device", "cpu"]
                + PRUNE_FLAGS)
        out["port_check"] = _rels(buf.getvalue())
    return out


def _jt(runs, name):
    return (C.load_pickle(os.path.join(runs["j"], name)),
            C.load_pickle(os.path.join(runs["t"], name)))


def _signs(runs):
    jp, tp = _jt(runs, "pod_model.pkl")
    return C.pod_signs(jp["POD_info"]["U"], tp["POD_info"]["U"])


def test_trunk_summary_is_the_jax_scripts(runs):
    """The same keys, integers (rom_dim, tpwl_points, scp_plan_rejects,
    the dU leg's rejects), strings and reject reasons; floats within
    SUMMARY_REL."""
    summary = runs["run"][0]
    ref = C.load_json(os.path.join(runs["j"], "trunk_tpwl_campaign.json"))
    assert ref["rom_dim"] == 6 and "dU_leg" in ref and "ilqr_rmse_mm" in ref
    C.same_summaries(summary, ref, SUMMARY_REL, skip=CLOCKS)


def test_trunk_artifacts_are_the_jax_scripts(runs):
    """Snapshots, rest, basis and dictionary array for array (in the JAX
    basis' signs); the three loops' pickles within LOOP_REL, their solve
    times by count."""
    s = _signs(runs)
    for name in ("pod_snapshots.pkl", "rest.pkl"):
        C.same_arrays(*_jt(runs, name), ARRAY_REL, name)
    for name in ("pod_model.pkl", "tpwl_model_snapshots.pkl"):
        ja, ta = _jt(runs, name)
        C.same_arrays(ja, C.port_in_jax_signs(ta, s), ARRAY_REL, name)
    for name in ("scp_fig8_sim.pkl", "scp_fig8_dU_sim.pkl",
                 "ilqr_fig8_sim.pkl"):
        js, ts = _jt(runs, name)
        for sim in (js, ts):
            sim.get("info", {}).pop("solve_times", None)
        C.same_arrays(js, ts, LOOP_REL, name)


def test_trunk_partial_rerun_keeps_the_other_stages_fields(runs):
    """--skip-collect --skip-ilqr: the dictionary's provenance read back
    from the pickle, the collect and iLQR fields kept, the loops' fields
    refreshed (the same numbers, so the JAX run's summary still holds)."""
    first, again = runs["run"][0], runs["rerun"][0]
    for k in ("rom_dim", "heldout_rel_err", "heldout_traj_rel_err",
              "ilqr_rmse_mm", "tpwl_points"):
        assert again[k] == first[k], k
    ref = C.load_json(os.path.join(runs["j"], "trunk_tpwl_campaign.json"))
    C.same_summaries(again, ref, SUMMARY_REL, skip=CLOCKS)


def test_trunk_gates_fail_on_the_stand_in_and_quarantine(runs):
    """The dictionary gate names the 709-node mesh: the stand-in fails it
    and the run's six artifacts went to <out>/rejected/."""
    _, fails, moved = runs["run"]
    assert any(f.startswith("trunk_tpwl_dictionary_loads_discrete")
               for f in fails), fails
    assert sorted(os.path.basename(p) for p in moved) == sorted([
        "trunk_tpwl_campaign.json", "scp_fig8_sim.pkl",
        "scp_fig8_dU_sim.pkl", "ilqr_fig8_sim.pkl", "pod_model.pkl",
        "tpwl_model_snapshots.pkl"])


def test_pruned_stand_in_dictionaries_are_the_jax_tools(runs):
    """Each run's dictionary thinned to about 40 points: the same kept
    points (the greedy pass is sign-blind), the written dictionaries
    equal in the JAX basis' signs, info equal (tau, bisected on the
    dictionaries' ranges, within ARRAY_REL); the --check rollouts'
    deviations within CHECK_ABS of the JAX tool's."""
    out, kept, tau = runs["prune"]
    ja, ta = _jt(runs, "pruned.pkl")
    ti, ji = dict(ta["info"]), dict(ja["info"])
    assert abs(ti.pop("prune_tau") - ji.pop("prune_tau")) <= ARRAY_REL * tau
    assert ti == ji and int(ti["nbr_lin"]) == len(kept)
    C.same_arrays(ja, C.port_in_jax_signs(ta, _signs(runs)), ARRAY_REL,
                  "pruned")
    assert len(runs["port_check"]) == len(runs["jax_check"]) == 3
    np.testing.assert_allclose(runs["port_check"], runs["jax_check"],
                               rtol=0, atol=CHECK_ABS)


def test_float32_robot_runs_the_collect_stages(tmp_path):
    """A float32 plant's stages, as the twins run them on the card: the
    dictionary (float32) and its POD basis (float64) are loaded in the
    plant's dtype, so the rollout check's output product no longer mixes
    the two (it raised on the card)."""
    import torch

    from soft_robot_control_tpu_torch.robots.robots import TrunkTetRobot
    from soft_robot_control_tpu_torch.tasks import recipes

    with C.campaign_standins(str(tmp_path)):
        robot = TrunkTetRobot(device="cpu", dtype=torch.float32)
        d = str(tmp_path / "run")
        recipes.collect_pod_data(robot, d, nbr_samples=2, t_step=0.05)
        recipes.compute_pod_basis(d, rom_dim=6)
        recipes.collect_tpwl_data(robot, d, threshold=15.0, nbr_samples=2,
                                  t_step=0.05, dynamics="discrete")
        chk = recipes.tpwl_rollout_check(robot, d, nbr_samples=2,
                                         t_step=0.05)
        model = recipes.load_tpwl(robot, d)
    assert model.q.dtype == model.H.dtype == torch.float32
    assert np.isfinite(chk["z_rom"]).all() and np.isfinite(chk["rel_err"])
