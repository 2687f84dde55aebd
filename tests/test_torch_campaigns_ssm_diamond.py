"""The Diamond SSM campaign twin against the JAX script, f64 on the CPU, on
the small Diamond stand-in (tests/tet_standins.py: DIAMOND_SMALL, its node
literals mapped onto the box as in test_torch_campaigns_diamond.py, and
the script's tip literal through its `tip_qv_output`).

The box's tip decays are no 6-dim spectral subspace: the fit's validation
rollouts blow up, so the script's gates reject it (both packages write
diamond_SSM_model.rejected.mat) and the loop runs the accepted model that
--out holds, the committed examples/diamond_tet/diamond_SSM_model.mat,
copied there first. Whether a ridge candidate's 500-step validation
rollout overflows is a knife edge on such data: the port's own decays
(within 1.1e-14 of JAX's) tip it the other way (learn_ssm raises), so the
port's fit runs on the JAX run's cached data (ssm_sysid_data.pkl, the
script's own cache) and its collection is held to JAX's in a run of its
own. The verdict is the data's, not the package's: on the port's data the
JAX script's learn_ssm raises as well. --quick and a 2.1 s loop (scored
from 2 s) are the script's shortest settings."""

import os
import shutil

import numpy as np
import pytest
from scipy.io import loadmat

import campaign_runs as C
import tet_standins as S
from torch_helpers import SSM_ARTIFACTS

from soft_robot_control_tpu_torch.examples import diamond_ssm_campaign

FLAGS = ["--quick", "--sim-duration", "2.1"]
# measured gaps (x86 CPU, f64): the decays and actuated runs within 1.1e-14 of
# their scale (the plant's PCG sums in other orders); from the same data
# the fit's coefficients equal (the same numpy on the host); the loop's u
# within 6.1e-9 and z within 3.4e-9 (the condensed ADMM's rounding)
DATA_REL = 1e-9
FIT_REL = 1e-9
LOOP_REL = 1e-7
SUMMARY_REL = 1e-8


def _map_tip(mp, *modules):
    for mod in modules:
        mp.setattr(mod, "tip_qv_output",
                   lambda n, node, _o=mod.tip_qv_output: _o(
                       n, S.DIAMOND_SMALL_NODES.get(node, node)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("campaigns_ssm_diamond"))
    dirs = {k: os.path.join(root, k) for k in ("j", "t", "collect",
                                                "t_mpc", "j_port_data")}
    for k in ("j", "t", "t_mpc"):
        os.makedirs(dirs[k])
        shutil.copy(SSM_ARTIFACTS["diamond"], dirs[k])
    out = {"dirs": dirs, "caches_before": C.real_plant_caches()}
    with C.campaign_standins(root), pytest.MonkeyPatch.context() as mp:
        jm = C.jax_script("diamond_ssm_campaign")
        _map_tip(mp, jm, diamond_ssm_campaign)
        C.run_jax(jm, ["--platform", "cpu", "--out", dirs["j"]] + FLAGS)
        shutil.copy(os.path.join(dirs["j"], "ssm_sysid_data.pkl"), dirs["t"])
        out["port"] = diamond_ssm_campaign.main(
            ["--device", "cpu", "--out", dirs["t"]] + FLAGS)
        with pytest.raises(RuntimeError, match="unstable dynamics fit"):
            diamond_ssm_campaign.main(["--device", "cpu", "--out",
                                       dirs["collect"], "--skip-mpc"]
                                      + FLAGS)
        os.makedirs(dirs["j_port_data"])
        shutil.copy(os.path.join(dirs["collect"], "ssm_sysid_data.pkl"),
                    dirs["j_port_data"])
        with pytest.raises(RuntimeError) as e:
            C.run_jax(jm, ["--platform", "cpu", "--out", dirs["j_port_data"],
                           "--skip-mpc"] + FLAGS)
        out["jax_on_port_data"] = str(e.value)
        out["port_mpc"] = diamond_ssm_campaign.main(
            ["--device", "cpu", "--out", dirs["t_mpc"], "--mpc-only"]
            + FLAGS)
    out["caches_after"] = C.real_plant_caches()
    return out


def test_collection_is_the_jax_scripts(runs):
    """The port's decays and actuated runs (its own collection, cached in
    ssm_sysid_data.pkl) within DATA_REL of the JAX script's."""
    d = runs["dirs"]
    ref = C.load_pickle(os.path.join(d["j"], "ssm_sysid_data.pkl"))
    got = C.load_pickle(os.path.join(d["collect"], "ssm_sysid_data.pkl"))
    assert len(got["decays"]) == len(ref["decays"]) == 4
    C.same_arrays(ref, got, DATA_REL, "sysid")


def test_rejected_fit_is_the_jax_scripts(runs):
    """From the same data both packages reject the fit: the same
    diamond_SSM_model.rejected.mat, array for array; neither replaced the
    accepted model in --out."""
    d = runs["dirs"]
    for name in ("diamond_SSM_model.rejected.mat",):
        a = loadmat(os.path.join(d["j"], name))["py_data"][0, 0]
        b = loadmat(os.path.join(d["t"], name))["py_data"][0, 0]
        for part in ("model", "params"):
            for k in a[part].dtype.names:
                x = np.asarray(a[part][k][0, 0], dtype=float)
                y = np.asarray(b[part][k][0, 0], dtype=float)
                assert x.shape == y.shape, k
                ok = np.isfinite(x)
                assert np.array_equal(ok, np.isfinite(y)), k
                gap = np.abs(x[ok] - y[ok]).max() if ok.any() else 0.0
                assert gap <= FIT_REL * max(np.abs(x[ok]).max(), 1e-300) \
                    if ok.any() else True, (part, k, gap)
    committed = open(SSM_ARTIFACTS["diamond"], "rb").read()
    for k in ("j", "t"):
        assert open(os.path.join(d[k], "diamond_SSM_model.mat"),
                    "rb").read() == committed


def test_fit_verdict_is_the_datas_in_both_packages(runs):
    """Each package's learn_ssm gives the same verdict on each data set:
    on the JAX script's decays both fit and reject the fit by its gates
    (test_rejected_fit_is_the_jax_scripts); on the port's own decays
    (within DATA_REL of JAX's) every ridge candidate's fit is unstable in
    both, the port's run and the JAX script's on the port's cache."""
    assert "unstable dynamics fit" in runs["jax_on_port_data"]
    assert not os.path.exists(os.path.join(
        runs["dirs"]["j_port_data"], "diamond_SSM_model.rejected.mat"))


def _same_loop(runs, jdir, tdir, summary, **fields):
    """The loop's summary and pickle in tdir against the JAX run's in
    jdir (with `fields` of the JAX summary replaced)."""
    ref = dict(C.load_json(os.path.join(jdir, "diamond_ssm_mpc.json")),
               **fields)
    C.same_summaries(summary, ref, SUMMARY_REL)
    C.same_summaries(summary, C.load_json(os.path.join(
        tdir, "diamond_ssm_mpc.json")), 0.0)
    js = C.load_pickle(os.path.join(jdir, "diamond_ssm_mpc_sim.pkl"))
    ts = C.load_pickle(os.path.join(tdir, "diamond_ssm_mpc_sim.pkl"))
    assert len(ts["info"].pop("solve_times")) == len(
        js["info"].pop("solve_times"))
    C.same_arrays(js, ts, LOOP_REL, "diamond_ssm_mpc_sim")


def test_loop_after_the_rejected_fit_is_the_jax_scripts(runs):
    """The closed loop on the accepted (committed) model: the summary's
    keys and numbers (held_out_rel NaN, stable false in both), the sim
    pickle within LOOP_REL."""
    assert runs["port"]["stable"] is False
    _same_loop(runs, runs["dirs"]["j"], runs["dirs"]["t"], runs["port"])


def test_mpc_only_is_the_jax_scripts(runs):
    """--mpc-only: the loop on the committed model without the fit, as
    the JAX script's loop after its rejected fit (the same model, plant
    and loop; the fit's fields are None and True without a fit)."""
    assert runs["port_mpc"]["held_out_rel"] is None
    _same_loop(runs, runs["dirs"]["j"], runs["dirs"]["t_mpc"],
               runs["port_mpc"], held_out_rel=None, stable=True)


def test_mpc_only_needs_an_accepted_model(tmp_path, monkeypatch):
    _map_tip(monkeypatch, diamond_ssm_campaign)
    with C.campaign_standins(str(tmp_path)):
        with pytest.raises(SystemExit, match="previously accepted"):
            diamond_ssm_campaign.main(["--device", "cpu", "--out",
                                       str(tmp_path / "empty"),
                                       "--mpc-only"])


def test_ssm_stand_in_runs_leave_the_real_plant_caches_alone(runs):
    assert runs["caches_after"] == runs["caches_before"]
