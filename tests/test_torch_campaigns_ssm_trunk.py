"""The Trunk SSM campaign twin against the JAX script, f64 on the CPU, on
the small Trunk stand-in (tests/tet_standins.py: TRUNK_SMALL, 171 nodes;
it holds the tip node 51).

As on the Diamond's stand-in (test_torch_campaigns_ssm_diamond.py), the
box's tip decays are no 6-dim spectral subspace: both packages' gates
reject their fits and write trunk_SSM_model.rejected.mat, and the loop
runs the accepted model in --out, the committed
examples/trunk_tet/trunk_SSM_model.mat copied there first (the script's
dense GuSTO with its trust region, inputs bounded at the envelope). Here
each package collects its own data (held within DATA_REL); on such data
the fit itself is a knife edge (a ridge candidate's validation rollout
overflows or not), so the rejected fits are compared by layout only: the
Diamond's file holds a fit from the same data array for array. --quick
and a 1.6 s loop (scored from 1.5 s) are the script's shortest
settings."""

import os
import shutil

import numpy as np
import pytest
from scipy.io import loadmat

import campaign_runs as C
from torch_helpers import SSM_ARTIFACTS

from soft_robot_control_tpu_torch.examples import trunk_ssm_campaign

FLAGS = ["--quick", "--sim-duration", "1.6"]
# measured gaps (x86 CPU, f64): the decays and actuated runs within 3.8e-14 of
# their scale (the plant's PCG sums in other orders); the loop's u within
# 1.6e-15 and z within 1.5e-14
DATA_REL = 1e-9
LOOP_REL = 1e-7
SUMMARY_REL = 1e-8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("campaigns_ssm_trunk"))
    dirs = {k: os.path.join(root, k) for k in ("j", "t")}
    for d in dirs.values():
        os.makedirs(d)
        shutil.copy(SSM_ARTIFACTS["trunk"], d)
    out = {"dirs": dirs, "caches_before": C.real_plant_caches()}
    with C.campaign_standins(root):
        jm = C.jax_script("trunk_ssm_campaign")
        C.run_jax(jm, ["--platform", "cpu", "--out", dirs["j"]] + FLAGS)
        out["port"] = C.run_port(trunk_ssm_campaign,
                                 ["--device", "cpu", "--out", dirs["t"]]
                                 + FLAGS)
        C.restore(out["port"][2])   # the loop's artifacts, to compare
    out["caches_after"] = C.real_plant_caches()
    return out


def test_collection_is_the_jax_scripts(runs):
    """The port's decays and actuated runs (its own collection, cached in
    sysid_data.pkl) within DATA_REL of the JAX script's."""
    d = runs["dirs"]
    ref = C.load_pickle(os.path.join(d["j"], "sysid_data.pkl"))
    got = C.load_pickle(os.path.join(d["t"], "sysid_data.pkl"))
    assert len(got["decays"]) == len(ref["decays"]) == 4
    C.same_arrays(ref, got, DATA_REL, "sysid")


def test_both_reject_their_fits(runs):
    """Both packages reject their fits and write
    trunk_SSM_model.rejected.mat with the same layout (fields and
    shapes); neither replaced the accepted model in --out."""
    d = runs["dirs"]
    name = "trunk_SSM_model.rejected.mat"
    a = loadmat(os.path.join(d["j"], name))["py_data"][0, 0]
    b = loadmat(os.path.join(d["t"], name))["py_data"][0, 0]
    for part in ("model", "params"):
        assert a[part].dtype.names == b[part].dtype.names
        for k in a[part].dtype.names:
            assert np.shape(a[part][k][0, 0]) == np.shape(b[part][k][0, 0])
    committed = open(SSM_ARTIFACTS["trunk"], "rb").read()
    for k in ("j", "t"):
        assert open(os.path.join(d[k], "trunk_SSM_model.mat"),
                    "rb").read() == committed


def test_loop_after_the_rejected_fit_is_the_jax_scripts(runs):
    """The closed loop on the accepted (committed) model: the summary's
    keys and numbers, the sim pickle within LOOP_REL. The Trunk SSM gate
    judges the run in its own --out, where the TPWL campaign's summary is
    absent: on the box the loop tracks worse than 8 mm, so the run fails
    that gate alone and its two artifacts go to --out/rejected/."""
    summary, fails, moved = runs["port"]
    d = runs["dirs"]
    assert summary["tracking_rmse_mm"] >= 8.0, summary
    assert len(fails) == 1 and fails[0].startswith(
        "trunk_ssm_mpc_gates"), fails
    assert sorted(os.path.basename(p) for p in moved) == [
        "ssm_mpc_sim.pkl", "trunk_ssm_mpc.json"]
    for dest in moved.values():
        assert os.path.dirname(dest) == os.path.join(d["t"], "rejected")
    ref = C.load_json(os.path.join(d["j"], "trunk_ssm_mpc.json"))
    C.same_summaries(summary, ref, SUMMARY_REL, skip=("solve_ms_mean",))
    C.same_summaries(summary, C.load_json(os.path.join(
        d["t"], "trunk_ssm_mpc.json")), 0.0)
    js = C.load_pickle(os.path.join(d["j"], "ssm_mpc_sim.pkl"))
    ts = C.load_pickle(os.path.join(d["t"], "ssm_mpc_sim.pkl"))
    assert len(ts["info"].pop("solve_times")) == len(
        js["info"].pop("solve_times"))
    C.same_arrays(js, ts, LOOP_REL, "ssm_mpc_sim")


def test_ssm_stand_in_runs_leave_the_real_plant_caches_alone(runs):
    assert runs["caches_after"] == runs["caches_before"]
