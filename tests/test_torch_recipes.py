"""The offline ROM pipeline and the Diamond recipe of the port against the
JAX package, in f64 on the CPU, from the same numpy seeds:

1. the recipes at tests/test_recipes.py's settings: the Diamond (:21-32:
   10 nodes, dt 0.02, 15 LHS samples for the POD snapshots and for the
   dictionary, threshold 0.4, the rollout check at :61) and the Trunk
   (:35-50: 10 samples each, the rollout check at 5) offline pipelines,
   each package's run once by a module-scoped fixture: the snapshots, r,
   the POD basis up to the sign of each column, the dictionary point by
   point (the same selected steps), the rollout check; then `run_scp` on
   the Diamond (:69-83's settings, cut to 0.7 s: 5 replans); and the
   rollout's error at chip_smoke.py phase 22(b)'s settings on 50 nodes;
2. the modules under them on small inputs: `rom/pod.py`'s offline half,
   `sim/snapshots.py`, `models/tpwl_build.py` under both eval_types (also
   with their Jacobians in several chunks), the robots,
   `tasks/calibration.py` (tests/test_aux.py:51-90's settings) and the
   numpy copies of `tasks/{targets,analysis}.py`.

Tolerances are stated beside each assertion.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soft_robot_control_tpu import robots as jrobots
from soft_robot_control_tpu.models import tpwl_build as jbuild
from soft_robot_control_tpu.models.tpwl import from_tpwl_dict as jfrom_dict
from soft_robot_control_tpu.rom import pod as jpod
from soft_robot_control_tpu.sim import snapshots as jsnap
from soft_robot_control_tpu.sim.fem_surrogate import (
    make_chain_robot as jchain, simulate as jsimulate)
from soft_robot_control_tpu.tasks import analysis as jana
from soft_robot_control_tpu.tasks import calibration as jcal
from soft_robot_control_tpu.tasks import recipes as jrec
from soft_robot_control_tpu.tasks import targets as jtgt
from soft_robot_control_tpu_torch import robots as trobots
from soft_robot_control_tpu_torch.models import tpwl_build as tbuild
from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
from soft_robot_control_tpu_torch.rom import pod as tpod
from soft_robot_control_tpu_torch.sim import snapshots as tsnap
from soft_robot_control_tpu_torch.sim.fem_surrogate import (
    make_chain_robot as tchain)
from soft_robot_control_tpu_torch.tasks import analysis as tana
from soft_robot_control_tpu_torch.tasks import calibration as tcal
from soft_robot_control_tpu_torch.tasks import recipes as trec
from soft_robot_control_tpu_torch.tasks import targets as ttgt
from soft_robot_control_tpu_torch.utils.device import to_numpy
from soft_robot_control_tpu_torch.utils.io import load_data

import torch_helpers  # noqa: F401  (single-threaded torch)


def _np(a):
    return to_numpy(a) if torch.is_tensor(a) else np.asarray(a)


def _close(got, ref, tol, msg=""):
    """max |got - ref| <= tol * max(1, max |ref|)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, msg
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    assert float(np.abs(got - ref).max() if ref.size else 0.0) <= \
        tol * scale, msg


# --------------------------------------------------------------------------
# 1. the recipes

SETTINGS = {
    # robot class, robot kwargs, POD data kwargs, TPWL data kwargs,
    # rollout check kwargs (tests/test_recipes.py)
    "diamond": ("DiamondRobot", dict(n_nodes=10, seed=0),
                dict(nbr_samples=15, t_step=0.3, seed=1),
                dict(threshold=0.4, nbr_samples=15, seed=2),
                dict(nbr_samples=6, seed=3)),
    "trunk": ("TrunkRobot", dict(n_nodes=10, seed=1),
              dict(nbr_samples=10, t_step=0.3, seed=5),
              dict(threshold=0.4, nbr_samples=10, seed=6),
              dict(nbr_samples=5, seed=7)),
}


def _robot(pkg, cls, kw):
    r = (getattr(jrobots, cls)(**kw) if pkg == "j"
         else getattr(trobots, cls)(device="cpu", **kw))
    r.dt = 0.02
    r.sequences.dt = 0.02
    return r


def _pipeline(pkg, rec, name, d):
    """One package's offline pipeline at SETTINGS[name] into directory d."""
    cls, rkw, pod_kw, tpwl_kw, check_kw = SETTINGS[name]
    robot = _robot(pkg, cls, rkw)
    snap = rec.collect_pod_data(robot, d, **pod_kw)
    pod = rec.compute_pod_basis(d, pod_tolerance=1e-8, pod_type="v")
    model = rec.collect_tpwl_data(robot, d, **tpwl_kw)
    check = rec.tpwl_rollout_check(robot, d, **check_kw)
    return dict(robot=robot, dir=d, snap=snap, pod=pod, model=model,
                check=check)


def _both(name, tmp_path_factory):
    """Both packages' offline pipelines at SETTINGS[name], and the sweep
    the dictionary was selected along (the port's, in its reduced
    coordinates)."""
    out = {pkg: _pipeline(pkg, rec, name, str(tmp_path_factory.mktemp(
        f"{name}_{pkg}"))) for pkg, rec in (("j", jrec), ("t", trec))}
    t = out["t"]
    _, _, _, tpwl_kw, _ = SETTINGS[name]
    u, _ = trec._lhs_excitation(t["robot"], tpwl_kw["nbr_samples"], 0.3,
                                tpwl_kw["seed"], 1.0)
    X = trec._sweep(t["robot"], u)[:-1]
    out["xr"] = _np(t["model"].rom.project_x(X))
    return out


@pytest.fixture(scope="module")
def diamond_runs(tmp_path_factory):
    return _both("diamond", tmp_path_factory)


@pytest.fixture(scope="module")
def trunk_runs(tmp_path_factory):
    return _both("trunk", tmp_path_factory)


@pytest.fixture(scope="module", params=["diamond", "trunk"])
def offline(request):
    return request.getfixturevalue(f"{request.param}_runs")


def _signs(Uj, Ut):
    """The sign of each POD column of the port against JAX's."""
    return np.sign(np.sum(_np(Uj) * _np(Ut), axis=0))


def _steps(q, v, xr):
    """The sweep steps of the dictionary's points (q, v): the sweep's
    reduced states that equal them (to 1e-12 of their scale)."""
    pts = np.concatenate((_np(v), _np(q)), axis=1)
    dist = np.abs(pts[:, None, :] - xr[None, :, :]).max(-1)
    steps = dist.argmin(1)
    assert np.all(dist.min(1) <= 1e-12 * max(1.0, np.abs(xr).max()))
    return steps


def test_snapshots_are_the_jax_packages(offline):
    """The POD sweep: states within 1e-12 of their scale (the same
    implicit steps, summed in another order), inputs and times equal."""
    js, ts = offline["j"]["snap"], offline["t"]["snap"]
    assert sorted(ts) == sorted(js)
    assert ts["dt"] == js["dt"]
    for k in ("t", "u"):
        assert np.array_equal(np.asarray(ts[k]), np.asarray(js[k])), k
    for k in ("q", "v", "q+", "v+"):
        _close(np.asarray(ts[k]), np.asarray(js[k]), 1e-12, k)
    rest = [load_data(os.path.join(offline[p]["dir"], "rest.pkl"))["rest"]
            for p in "jt"]
    assert np.array_equal(rest[0], rest[1])


def test_pod_basis_is_the_jax_packages(offline):
    """The same r, the basis within 1e-10 up to each column's sign, the
    singular values within 1e-10 of the largest, the pickle's layout."""
    jp, tp = offline["j"]["pod"], offline["t"]["pod"]
    assert sorted(tp) == sorted(jp) == ["POD_info", "Sigma", "config"]
    assert tp["config"] == jp["config"]
    Uj, Ut = jp["POD_info"]["U"], tp["POD_info"]["U"]
    assert Ut.shape == Uj.shape and 2 <= Ut.shape[1] <= 10
    _close(Ut * _signs(Uj, Ut), Uj, 1e-10)
    _close(tp["Sigma"], jp["Sigma"], 1e-10)
    assert np.array_equal(tp["POD_info"]["q_ref"], jp["POD_info"]["q_ref"])
    saved = load_data(os.path.join(offline["t"]["dir"], "pod_model.pkl"))
    assert np.array_equal(saved["POD_info"]["U"], Ut)


def test_dictionary_is_the_jax_packages(offline):
    """The same selected steps; the points, inputs and matrices within
    1e-10 of their scale in the basis of the same signs."""
    jm, tm = offline["j"]["model"], offline["t"]["model"]
    assert tm.num_points == jm.num_points >= 2
    s = _signs(jm.rom.U, tm.rom.U)
    s2 = np.concatenate((s, s))
    # JAX's points in the port's coordinates, on the port's sweep
    jsteps = _steps(np.asarray(jm.q) * s, np.asarray(jm.v) * s,
                    offline["xr"])
    assert np.array_equal(_steps(tm.q, tm.v, offline["xr"]), jsteps)
    _close(_np(tm.q) * s, jm.q, 1e-10, "q")
    _close(_np(tm.v) * s, jm.v, 1e-10, "v")
    assert np.array_equal(_np(tm.u), np.asarray(jm.u))
    _close(s2[:, None] * _np(tm.A_c) * s2[None, :], jm.A_c, 1e-10, "A_c")
    _close(s2[:, None] * _np(tm.B_c), jm.B_c, 1e-10, "B_c")
    _close(s2 * _np(tm.d_c), jm.d_c, 1e-10, "d_c")
    _close(_np(tm.H) * s2, jm.H, 1e-10, "H")
    _close(_np(tm.C) * s2, jm.C, 1e-10, "C")


def test_dictionary_round_trips_through_the_pickle(offline):
    """to_tpwl_dict -> from_tpwl_dict gives the port's model back exactly,
    and the saved pickle loads into the JAX package as the same arrays."""
    tm = offline["t"]["model"]
    back = from_tpwl_dict(tbuild.to_tpwl_dict(tm), device="cpu")
    for k in ("q", "v", "u", "A_c", "B_c", "d_c"):
        assert torch.equal(getattr(back, k), getattr(tm, k)), k
    assert torch.equal(back.rom.U, tm.rom.U)
    path = os.path.join(offline["t"]["dir"], "tpwl_model_snapshots.pkl")
    jm = jfrom_dict(path)
    for k in ("q", "A_c", "d_c"):
        assert np.array_equal(np.asarray(getattr(jm, k)),
                              _np(getattr(tm, k))), k


def test_rollout_check_is_the_jax_packages(offline):
    """The ROM's z and the plant's within 1e-10 of their scale; the MSEs
    within 1e-8 of each other's (relative)."""
    jc, tc = offline["j"]["check"], offline["t"]["check"]
    _close(tc["z_true"], jc["z_true"], 1e-10, "z_true")
    _close(tc["z_rom"], jc["z_rom"], 1e-10, "z_rom")
    assert tc["mse"] == pytest.approx(jc["mse"], rel=1e-8)
    assert tc["rel_err"] == pytest.approx(jc["rel_err"], rel=1e-8)


def test_wide_settings_rollout_is_the_jax_packages(tmp_path):
    """The offline pipeline at chip_smoke.py phase 22(b)'s settings (the
    robot's dt 0.01, the recipes' defaults: 40 LHS samples, the basis at r
    = 30, the rollout check at 10 samples) on a chain of 50 nodes: the same
    dictionary size and the rollout's rel_err and MSE within 1e-8 of the
    JAX package's (relative). The rel_err is the method's, not the port's
    (0.614 here; tools/pipeline_widths.py reads it at other widths)."""
    out = {}
    for p, rec in (("j", jrec), ("t", trec)):
        robot = (jrobots.DiamondRobot(n_nodes=50) if p == "j"
                 else trobots.DiamondRobot(n_nodes=50, device="cpu"))
        d = str(tmp_path / p)
        rec.collect_pod_data(robot, d)
        rec.compute_pod_basis(d, rom_dim=30)
        model = rec.collect_tpwl_data(robot, d)
        out[p] = model.num_points, rec.tpwl_rollout_check(robot, d,
                                                          nbr_samples=10)
    (nj, cj), (nt, ct) = out["j"], out["t"]
    assert nt == nj >= 2
    assert ct["rel_err"] == pytest.approx(cj["rel_err"], rel=1e-8)
    assert ct["mse"] == pytest.approx(cj["mse"], rel=1e-8)


def test_run_scp_is_the_jax_packages(diamond_runs):
    """The Diamond's GuSTO MPC + EKF closed loop, 0.7 s after a 0.5 s
    delay (5 replans), at the golden test's tolerances (z rtol 1e-6 / atol
    1e-9, u rtol 1e-5 / atol 1e-8; tests/test_torch_closed_loop.py), with
    GuSTO's defaults, polish included; the summary's tracking MSE within
    1e-8 (relative)."""
    offline = diamond_runs
    sims = {}
    for p, rec in (("j", jrec), ("t", trec)):
        robot = offline[p]["robot"]
        Hf = robot.get_output_model()
        z0 = float((_np(robot.plant.x_rest()) @ Hf.T)[0])
        t_t, z_t = jtgt.sine_setpoint(T=4.0, duration=12.0, dt=0.02,
                                      amplitude=0.05)
        sims[p] = rec.run_scp(robot, offline[p]["dir"], t_t, z_t + z0,
                              N=5, N_replan=2, Qz=np.array([[200.0]]),
                              R=1e-6 * np.eye(robot.n_cables),
                              sim_duration=0.7, delay=0.5)
    js, ts = sims["j"], sims["t"]
    np.testing.assert_allclose(ts["z"], js["z"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ts["u"], js["u"], rtol=1e-5, atol=1e-8)
    assert len(ts["info"]["solve_times"]) == len(
        js["info"]["solve_times"]) >= 3
    assert ts["info"]["plan_rejects"] == js["info"]["plan_rejects"]
    jst = jana.summarize(js, t_t + 0.5, z_t + z0, t_start=0.5)
    tst = tana.summarize(ts, t_t + 0.5, z_t + z0, t_start=0.5)
    assert tst["tracking"]["mse"] == pytest.approx(
        jst["tracking"]["mse"], rel=1e-8)
    saved = load_data(os.path.join(offline["t"]["dir"], "scp_sim.pkl"))
    assert np.array_equal(saved["z"], ts["z"])


def _sine_target(robot, amplitude=0.05):
    """tests/test_recipes.py's sine about the rest tip: (t, z)."""
    Hf = robot.get_output_model()
    z0 = float((_np(robot.plant.x_rest()) @ Hf.T)[0])
    t_t, z_t = jtgt.sine_setpoint(T=4.0, duration=12.0, dt=0.02,
                                  amplitude=amplitude)
    return t_t, z_t + z0


def _each(offline, run):
    """run(package's recipes, robot, directory) for both packages."""
    return {p: run(rec, offline[p]["robot"], offline[p]["dir"])
            for p, rec in (("j", jrec), ("t", trec))}


def _same_loop(sims, prefix, dirname):
    """Two closed loops at the golden test's tolerances (z rtol 1e-6 /
    atol 1e-9, u rtol 1e-5 / atol 1e-8), the same number of replans; the
    port's pickle holds numpy arrays only and equals what it returned."""
    js, ts = sims["j"], sims["t"]
    np.testing.assert_allclose(ts["z"], js["z"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ts["u"], js["u"], rtol=1e-5, atol=1e-8)
    saved = load_data(os.path.join(dirname, f"{prefix}_sim.pkl"))
    assert np.array_equal(saved["z"], ts["z"])

    def no_tensor(obj):
        if isinstance(obj, dict):
            return all(no_tensor(v) for v in obj.values())
        if isinstance(obj, list):
            return all(no_tensor(v) for v in obj)
        return not torch.is_tensor(obj)

    assert no_tensor(saved)


def test_run_ilqr_is_the_jax_packages(diamond_runs):
    """iLQR along the sine over tf = 0.4 s (20 steps, the iLQR config's
    defaults), then 0.6 s of closed loop after a 0.2 s delay: z and u at
    the golden test's tolerances."""
    tt, zt = _sine_target(diamond_runs["t"]["robot"])
    sims = _each(diamond_runs, lambda rec, robot, d: rec.run_ilqr(
        robot, d, tt, zt[:, None] if zt.ndim == 1 else zt,
        Qz=np.array([[200.0]]), sim_duration=0.6, delay=0.2, tf=0.4))
    assert len(sims["t"]["t"]) == 30
    _same_loop(sims, "ilqr", diamond_runs["t"]["dir"])


def test_run_scp_open_loop_is_the_jax_packages(diamond_runs):
    """GuSTO's open-loop plan at N=20 (dt 0.04) and its replay on the
    plant (the plan's inputs interpolated onto the plant's 0.02 s grid):
    topt exact, uopt and zopt within 1e-8 of their scale, the replay's z
    within 1e-10. GuSTO's LOCPs run with polish=False: the polish step
    guesses the active set from the signs of the ADMM duals, which are
    rounding noise at an inactive bound, so two runtimes can take
    different plans from the same QP (ROADMAP.md section 3)."""
    tt, zt = _sine_target(diamond_runs["t"]["robot"])
    out = _each(diamond_runs, lambda rec, robot, d: rec.run_scp_open_loop(
        robot, d, tt, zt[:, None] if zt.ndim == 1 else zt, N=20,
        polish=False))
    jo, to = out["j"], out["t"]
    assert np.array_equal(to["topt"], np.asarray(jo["topt"]))
    _close(to["uopt"], np.asarray(jo["uopt"]), 1e-8, "uopt")
    _close(to["zopt"], np.asarray(jo["zopt"]), 1e-8, "zopt")
    # the plant's rest state, then one step a grid point of [0, topt[-1])
    assert to["z_replay"].shape == np.asarray(jo["z_replay"]).shape == (
        41, 1)
    _close(to["z_replay"], jo["z_replay"], 1e-10, "z_replay")


def test_run_rompc_is_the_jax_packages(diamond_runs):
    """ROMPC on the dictionary's first point at the baselines campaign's
    weights (N=20, N_replan=4) with the condensed LOCP and the fixed-budget
    staged ADMM ('pallas': the batched ADMM kernel's plain version here,
    the JAX Pallas kernel in interpret mode), the card path: 0.8 s after a
    0.2 s delay (10 replans), z and u at the golden test's tolerances.
    That backend has no polish step, so its plans are unambiguous."""
    tt, zt = _sine_target(diamond_runs["t"]["robot"])
    sims = _each(diamond_runs, lambda rec, robot, d: rec.run_rompc(
        robot, d, tt, zt[:, None] if zt.ndim == 1 else zt, N=20,
        N_replan=4, Qz=np.array([[100.0]]), R=1e-4 * np.eye(4),
        sim_duration=0.8, delay=0.2, locp_backend="condensed",
        qp_backend="pallas"))
    assert len(sims["t"]["info"]["solve_times"]) == len(
        sims["j"]["info"]["solve_times"]) >= 8
    _same_loop(sims, "rompc", diamond_runs["t"]["dir"])


def test_run_koopman_is_the_jax_packages(diamond_runs):
    """The Koopman recipe at the baselines campaign's settings (delay 1,
    degree 2, N=10, rollout_horizon=4, absolute targets) on 16 LHS samples
    of EDMD data, condensed and 'pallas' as ROMPC above: 0.6 s after a 0.2
    s delay, z and u at the golden test's tolerances. The delay rows
    (vectorized in the port) are the JAX recipe's loop's exactly."""
    tt, zt = _sine_target(diamond_runs["t"]["robot"])
    sims = _each(diamond_runs, lambda rec, robot, d: rec.run_koopman(
        robot, d, tt, zt[:, None] if zt.ndim == 1 else zt, delay_embed=1,
        degree=2, N=10, rollout_horizon=4, sim_duration=0.6, delay=0.2,
        nbr_samples=16, absolute_targets=True, locp_backend="condensed",
        qp_backend="pallas"))
    assert len(sims["t"]["info"]["solve_times"]) >= 3
    _same_loop(sims, "koopman", diamond_runs["t"]["dir"])
    rng = np.random.default_rng(0)
    yn, un = rng.normal(size=(9, 3)), rng.normal(size=(9, 4))
    for d in (0, 1, 2):
        loop = np.asarray([np.hstack([yn[t]]
                                     + [yn[t - j - 1] for j in range(d)]
                                     + [un[t - j - 1] for j in range(d)])
                           for t in range(d, len(yn))])
        assert np.array_equal(trec._delay_rows(yn, un, d), loop)


# --------------------------------------------------------------------------
# 2. the modules, on small inputs


@pytest.fixture(scope="module")
def plants():
    """tests/test_aux.py's and tests/test_snapshots.py's plant in both
    packages: the chain of 8 nodes and 3 cables, seed 0."""
    return jchain(n_nodes=8, n_cables=3, seed=0), tchain(
        n_nodes=8, n_cables=3, seed=0, device="cpu")


def _snap_dict(seed=0, T=30, n=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(T, n))
    v = rng.normal(size=(T, n))
    return {"q": list(q), "v": list(v), "v+": list(v + 0.1 * rng.normal(
        size=(T, n))), "q+": list(q), "u": list(rng.normal(size=(T, 3))),
        "t": 0.02 * np.arange(T), "dt": 0.02}


@pytest.mark.parametrize("pod_type", ["q", "v", "a"])
@pytest.mark.parametrize("preprocess", [[], ["normalize"],
                                        ["substract_mean"],
                                        ["normalize", "substract_mean"]])
def test_snapshot_matrices_are_the_jax_packages(pod_type, preprocess):
    """get_snapshots and process_snapshots: numpy in both, bit-identical."""
    data = _snap_dict()
    got = tpod.process_snapshots(tpod.get_snapshots(data, pod_type),
                                 preprocess, {"nbr_clusters": 0})
    ref = jpod.process_snapshots(jpod.get_snapshots(data, pod_type),
                                 preprocess, {"nbr_clusters": 0})
    assert np.array_equal(got, ref)
    with pytest.raises(ValueError):
        tpod.get_snapshots(data, "x")


@pytest.mark.parametrize("rom_dim,tol", [(None, 1e-3), (4, 1e-4)])
def test_run_pod_is_the_jax_packages(tmp_path, rom_dim, tol):
    """run_POD from the same snapshot pickle: the same saved layout and r,
    U within 1e-10 up to sign; the port's pickle loads as a POD of the
    same basis in both packages."""
    from soft_robot_control_tpu_torch.utils.io import save_data

    path = str(tmp_path / "snaps.pkl")
    save_data(path, _snap_dict(seed=3))
    out = {}
    for p, mod in (("j", jpod), ("t", tpod)):
        cfg = mod.pod_config()
        cfg.pod_tolerance, cfg.pod_type = tol, "q"
        out[p] = mod.run_POD(path, str(tmp_path / f"pod_{p}.pkl"), cfg,
                             rom_dim=rom_dim)
    Uj, Ut = out["j"]["POD_info"]["U"], out["t"]["POD_info"]["U"]
    assert Ut.shape == Uj.shape and (rom_dim is None or Ut.shape[1] == 4)
    _close(Ut * _signs(Uj, Ut), Uj, 1e-10)
    assert load_data(str(tmp_path / "pod_t.pkl")).keys() == out["j"].keys()
    rom = tpod.load_POD(str(tmp_path / "pod_t.pkl"), device="cpu")
    assert np.array_equal(_np(rom.U), Ut)
    assert np.array_equal(np.asarray(jpod.load_POD(
        str(tmp_path / "pod_t.pkl")).U), Ut)


def test_kmeans_centroids_are_the_jax_packages():
    """k-means preprocessing: both call scikit-learn with the same seed."""
    pytest.importorskip("sklearn")
    s = np.asarray(_snap_dict(seed=4)["q"])
    assert np.array_equal(tpod.compute_kmeans_centroids(s, 3),
                          jpod.compute_kmeans_centroids(s, 3))


@pytest.mark.parametrize("save_dynamics", [True, False])
def test_open_loop_collection_is_the_jax_packages(plants, tmp_path,
                                                   save_dynamics):
    """run_open_loop_collection on tests/test_snapshots.py's inputs (every
    fifth point saved), with and without the dynamics: the points within
    1e-12 of their scale, (A, B, d) within 1e-12 (the port's in one
    batched call), the same saved file."""
    jp, tp = plants
    T = 30
    u = np.abs(np.random.default_rng(1).normal(size=(T, 3)))
    save = np.zeros(T, bool)
    save[::5] = True
    out = {}
    for p, mod, plant in (("j", jsnap, jp), ("t", tsnap, tp)):
        out[p] = mod.run_open_loop_collection(
            plant, u, save, 0.02, mod.SnapshotData(save_dynamics),
            filename=str(tmp_path / f"{p}.pkl"))
    assert sorted(out["t"]) == sorted(out["j"])
    assert len(out["t"]["q"]) == 6
    for k in out["j"]:
        if k != "dt":
            _close(np.asarray(out["t"][k]), np.asarray(out["j"][k]), 1e-12,
                   k)
    assert load_data(str(tmp_path / "t.pkl")).keys() == out["j"].keys()


def test_custom_collector_sees_the_same_points(plants):
    """A collector that saves a point only far from the saved ones
    (tests/test_snapshots.py's distance collector): the same choices."""
    jp, tp = plants
    u = np.abs(np.random.default_rng(2).normal(size=(40, 3)))

    def collector(mod):
        class Far(mod.SnapshotData):
            def save_snapshot(self, point, prev_point):
                if not self.dict["q"]:
                    return True
                d = np.linalg.norm(np.asarray(self.dict["q"]) - point.q,
                                   axis=1)
                return d.min() >= 0.05
        return Far(save_dynamics=False)

    got = tsnap.run_open_loop_collection(tp, u, np.ones(40, bool), 0.02,
                                         collector(tsnap))
    ref = jsnap.run_open_loop_collection(jp, u, np.ones(40, bool), 0.02,
                                         collector(jsnap))
    assert np.array_equal(got["t"], ref["t"]) and 1 < len(got["t"]) < 40


def _sweep_and_rom(jp, tp, T=120, r=4):
    """A seeded sweep of the chain plant in both packages, and a POD basis
    of its positions handed to both."""
    rng = np.random.default_rng(9)
    u = np.repeat(np.abs(rng.normal(size=(T // 10, 3))) * 2.0, 10, axis=0)
    X = np.asarray(jsimulate(jp, jp.x_rest(), jnp.asarray(u), 0.02))
    n = jp.n_nodes_dof
    U, _, _ = np.linalg.svd((X[:, n:] - X[0, n:]).T, full_matrices=False)
    info = {"U": U[:, :r], "q_ref": X[0, n:], "v_ref": np.zeros(n)}
    return X, u, info


@pytest.mark.parametrize("cfg", [
    dict(eval_type="distance", TPWL_threshold=0.3),
    dict(eval_type="distance", TPWL_threshold=0.2,
         TPWL_separate_calculation=True),
    dict(eval_type="dynamics", TPWL_threshold=0.02, dt=0.02,
         discr_method="be"),
    dict(eval_type="dynamics", TPWL_threshold=0.01, dt=0.02,
         TPWL_weighting_factors={"q": 1.0, "v": 0.1},
         dist_weights={"q": 1.0, "v": 0.5}, discr_method="zoh"),
])
def test_build_tpwl_model_is_the_jax_packages(plants, cfg):
    """build_tpwl_model under both criteria (the port selects first and
    computes the distance criterion's Jacobians in one batched call; the
    dynamics criterion computes each as it is added, as JAX does): the
    same points, the matrices within 1e-10 of their scale; the dictionary
    and its output maps through to_tpwl_dict."""
    jp, tp = plants
    X, u, info = _sweep_and_rom(jp, tp)
    Hf = np.zeros((1, 16))
    Hf[0, 15] = 1.0
    kw = dict(params={"dist_weights": {"q": 10.0, "v": 1.0}}, Hf=Hf,
              Cf=np.eye(16)[[3, 11]], discr_method="be")
    if cfg["eval_type"] == "dynamics":
        jcfg, tcfg = jbuild.tpwl_dynamics_config(**cfg), \
            tbuild.tpwl_dynamics_config(**cfg)
    else:
        jcfg, tcfg = jbuild.tpwl_config(**cfg), tbuild.tpwl_config(**cfg)
    jm = jbuild.build_tpwl_model(jp, jpod.POD(info), X[:-1], u, config=jcfg,
                                 **kw)
    tm = tbuild.build_tpwl_model(tp, tpod.POD(info, device="cpu"), X[:-1],
                                 u, config=tcfg, device="cpu", **kw)
    assert tm.num_points == jm.num_points >= 2
    jd, td = jbuild.to_tpwl_dict(jm), tbuild.to_tpwl_dict(tm)
    assert sorted(td) == sorted(jd)
    for k in ("q", "v", "u", "A_c", "B_c", "d_c"):
        _close(td[k], jd[k], 1e-10, k)
    _close(tm.H, jm.H, 1e-12, "H")
    assert td["dt"] == jd["dt"] == -1


def test_reduced_affine_dynamics_takes_batches(plants):
    """The dense projection at three points in one call equals the JAX
    package's at each point (1e-12 of the scale)."""
    jp, tp = plants
    X, u, info = _sweep_and_rom(jp, tp, T=60)
    jr, tr = jpod.POD(info), tpod.POD(info, device="cpu")
    idx = [5, 30, 59]
    got = tbuild.reduced_affine_dynamics(tp, tr, X[idx], u[idx])
    for k, i in enumerate(idx):
        ref = jbuild.reduced_affine_dynamics(jp, jr, X[i], u[i])
        for a, b in zip(got, ref):
            _close(a[k], b, 1e-12)


def test_jacobians_in_several_chunks_are_the_jax_packages(plants,
                                                         monkeypatch):
    """run_open_loop_collection (15 saved points) and build_tpwl_model's
    distance criterion with a chunk budget (JACOBIAN_CHUNK_BYTES) of two
    dense (2n)^2 Jacobians, so that the points go in several chunks and
    the last one is short, as at the Diamond mesh's width: the points and
    matrices within the one-chunk tests' tolerances (1e-12 and 1e-10 of
    their scale) of the JAX package's."""
    jp, tp = plants
    monkeypatch.setattr(tsnap, "JACOBIAN_CHUNK_BYTES",
                        2 * (2 * tp.n_nodes_dof) ** 2 * 8)
    sizes = []
    in_chunks = tsnap.in_chunks

    def counted(fn, X, U):
        def chunk(x, u):
            sizes.append(x.shape[0])
            return fn(x, u)
        return in_chunks(chunk, X, U)

    monkeypatch.setattr(tsnap, "in_chunks", counted)
    monkeypatch.setattr(tbuild, "in_chunks", counted)
    T = 30
    u = np.abs(np.random.default_rng(1).normal(size=(T, 3)))
    save = np.zeros(T, bool)
    save[::2] = True
    got = tsnap.run_open_loop_collection(tp, u, save, 0.02,
                                         tsnap.SnapshotData(True))
    ref = jsnap.run_open_loop_collection(jp, u, save, 0.02,
                                         jsnap.SnapshotData(True))
    assert sizes == [2] * 7 + [1]
    for k in ("q", "v", "u", "q+", "v+", "A", "B", "d"):
        _close(np.asarray(got[k]), np.asarray(ref[k]), 1e-12, k)
    sizes.clear()
    X, u, info = _sweep_and_rom(jp, tp)
    cfg = dict(eval_type="distance", TPWL_threshold=0.3)
    jm = jbuild.build_tpwl_model(jp, jpod.POD(info), X[:-1], u,
                                 config=jbuild.tpwl_config(**cfg))
    tm = tbuild.build_tpwl_model(tp, tpod.POD(info, device="cpu"), X[:-1],
                                 u, config=tbuild.tpwl_config(**cfg),
                                 device="cpu")
    assert tm.num_points == jm.num_points >= 3
    assert sum(sizes) == tm.num_points and max(sizes) == 2
    jd, td = jbuild.to_tpwl_dict(jm), tbuild.to_tpwl_dict(tm)
    for k in ("q", "v", "u", "A_c", "B_c", "d_c"):
        _close(td[k], jd[k], 1e-10, k)


@pytest.mark.parametrize("cls", ["DiamondRobot", "TrunkRobot", "FingerRobot",
                                 "SurrogateRobot"])
def test_robots_are_the_jax_packages(cls):
    """The same plant arrays and parameters, limits, sequences and
    measurement and output maps; the port's plant in the dtype asked."""
    j = getattr(jrobots, cls)(n_nodes=9, seed=3)
    t = getattr(trobots, cls)(n_nodes=9, seed=3, device="cpu")
    for k in ("K", "H", "q_rest"):
        assert np.array_equal(_np(getattr(t.plant, k)),
                              np.asarray(getattr(j.plant, k))), k
    for k in ("m_node", "alpha", "beta", "gamma"):
        assert getattr(t.plant, k) == float(getattr(j.plant, k)), k
    for k in ("name", "n_cables", "u_min", "u_max", "dt", "nb_nodes"):
        assert getattr(t, k) == getattr(j, k), k
    assert type(t.sequences).__name__ == type(j.sequences).__name__
    assert np.array_equal(t.get_measurement_model(), j.get_measurement_model())
    assert np.array_equal(t.get_output_model([2, 8]),
                          j.get_output_model([2, 8]))
    f32 = getattr(trobots, cls)(n_nodes=9, device="cpu", dtype=torch.float32)
    assert f32.plant.K.dtype == torch.float32


def test_calibration_is_the_jax_packages(plants):
    """tests/test_aux.py:51-90's calibrations in both packages: the rest
    and the step responses within 1e-12 of their scale, the same output
    node, the gains within 1e-10, and the gain-scaled plant's H."""
    jp, tp = plants
    qj, vj = jcal.calibrate_rest(jp, settle_time=3.0, dt=0.02)
    qt, vt = tcal.calibrate_rest(tp, settle_time=3.0, dt=0.02)
    _close(qt, qj, 1e-12)
    _close(vt, vj, 1e-12)
    n = 8
    u = np.zeros((100, 3))
    u[:, 0] = 2.0
    X = np.asarray(jsimulate(jp, jp.x_rest(), jnp.asarray(u), 0.02))
    measured = X[1:, n + n - 2] + 0.3
    bt, mt = tcal.calibrate_output_node(X[1:, n:], measured)
    bj, mj = jcal.calibrate_output_node(X[1:, n:], measured)
    assert bt == bj == n - 2 and mt == mj
    rj = jcal.collect_calibration_responses(jp, 0.3, dt=0.02, t_step=0.4,
                                            t_sine=0.4)
    rt = tcal.collect_calibration_responses(tp, 0.3, dt=0.02, t_step=0.4,
                                            t_sine=0.4)
    assert sorted(rt) == sorted(rj) == [0, 1, 2]
    for c in rj:
        for k in ("step", "sine"):
            assert np.array_equal(rt[c][k][0], rj[c][k][0])
            _close(rt[c][k][1], rj[c][k][1], 1e-12, f"{c} {k}")
    u[:, 0] = 0.3
    X = np.asarray(jsimulate(jp, jp.x_rest(), jnp.asarray(u[:150]), 0.02))
    true_defl = X[-1, n + n - 1] - np.asarray(jp.q_rest)[n - 1]
    gj = jcal.calibrate_actuator_gains(jp, {0: 1.5 * true_defl}, 0.3,
                                       dt=0.02)
    gt = tcal.calibrate_actuator_gains(tp, {0: 1.5 * true_defl}, 0.3,
                                       dt=0.02)
    _close(gt, gj, 1e-10)
    _close(tcal.apply_actuator_gains(tp, gt).H,
           jcal.apply_actuator_gains(jp, gj).H, 1e-12)


def test_targets_and_analysis_are_the_jax_packages():
    """The numpy copies: targets and the summary bit-identical."""
    for f, kw in (("figure8", dict(M=2, T=5.0, N=100, radius=3.0)),
                  ("circle", dict(M=1, T=4.0, N=50, radius=2.0)),
                  ("sine_setpoint", dict(T=4.0, duration=2.0, dt=0.02))):
        for a, b in zip(getattr(ttgt, f)(**kw), getattr(jtgt, f)(**kw)):
            assert np.array_equal(a, b), f
    rng = np.random.default_rng(5)
    sim = {"t": 0.02 * np.arange(50), "z": rng.normal(size=(50, 2)),
           "info": {"solve_times": list(rng.uniform(size=7)) + [None]}}
    t_t, z_t = jtgt.figure8(T=1.0, N=40)
    got = tana.summarize(sim, t_t, z_t, dims=[1], t_start=0.1, label="x")
    ref = jana.summarize(sim, t_t, z_t, dims=[1], t_start=0.1, label="x")
    assert got["label"] == ref["label"]
    assert got["solve_times"] == ref["solve_times"]
    for k in ref["tracking"]:
        assert np.array_equal(got["tracking"][k], ref["tracking"][k]), k
    assert tana.solve_time_stats({}) is None
