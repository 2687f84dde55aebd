"""The port's analysis tasks against the JAX package, on the CPU in f64:
tasks/sysid_export.py (the decay and actuated experiments on the chain
surrogate and on tests/test_fem_tet.py's tet box, where the batch is the
PCG step with a stop a lane; the CSV exports), tasks/baseline_comparison.py
(the same metric table from either package's pickles) and tasks/
plotting.py (the same lines drawn; skipped where matplotlib is absent).
Tolerances are stated beside each assertion."""

import os

import numpy as np
import pytest
import torch

from soft_robot_control_tpu.sim import fem_tet as J
from soft_robot_control_tpu.sim.fem_surrogate import (
    make_chain_robot as jchain)
from soft_robot_control_tpu.tasks import baseline_comparison as jbc
from soft_robot_control_tpu.tasks import sysid_export as jsys
from soft_robot_control_tpu.utils.io import save_data as jsave
from soft_robot_control_tpu_torch.sim import fem_tet as P
from soft_robot_control_tpu_torch.sim.fem_surrogate import (
    make_chain_robot as tchain)
from soft_robot_control_tpu_torch.tasks import baseline_comparison as tbc
from soft_robot_control_tpu_torch.tasks import sysid_export as tsys
from soft_robot_control_tpu_torch.utils.io import save_data as tsave

import torch_helpers  # noqa: F401  (single-threaded torch)
from tet_box import box_plant


def _close(got, ref, tol, msg=""):
    """max |got - ref| <= tol * max(1, max |ref|)."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape, msg
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale, msg


@pytest.fixture(scope="module")
def chains():
    return (jchain(n_nodes=8, n_cables=3, seed=0),
            tchain(n_nodes=8, n_cables=3, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def boxes():
    return box_plant(J), box_plant(P, device="cpu")


def _hf(n, cols):
    """Rows picking the state entries `cols` of a 2n state."""
    Hf = np.zeros((len(cols), 2 * n))
    for i, c in enumerate(cols):
        Hf[i, c] = 1.0
    return Hf


@pytest.mark.parametrize("plant", ["chain", "tet_box"])
def test_decays_and_actuated_runs_are_the_jax_packages(chains, boxes,
                                                        plant):
    """collect_decay_trajectories (3 levels, one batch) and
    collect_actuated_trajectories (3 sequences of one length, one batch;
    then two of different lengths, one at a time): the same times and
    inputs, z within 1e-10 of its scale; numpy out in the plant's dtype.
    On the tet box each lane's PCG stops at its own iteration."""
    if plant == "chain":
        jp, tp = chains
        levels = [np.array([1.0, 0.0, 0.5]), np.array([0.0, 2.0, 0.0]),
                  np.array([0.3, 0.3, 0.3])]
        hold, decay, T = 0.3, 0.4, 25
    else:
        jp, tp = boxes
        levels = [np.array([40.0, 0.0]), np.array([0.0, 60.0]),
                  np.array([20.0, 20.0])]
        hold, decay, T = 0.05, 0.06, 6
    n = tp.n_nodes_dof if plant == "chain" else tp.state_dim // 2
    Hf = _hf(n, [n - 1, 2 * n - 1, 2 * n - 2])
    got = tsys.collect_decay_trajectories(tp, Hf, levels, hold, decay, 0.01)
    ref = jsys.collect_decay_trajectories(jp, Hf, levels, hold, decay, 0.01)
    assert len(got) == len(ref) == 3
    for (tt, zt), (tj, zj) in zip(got, ref):
        assert np.array_equal(tt, tj)
        assert isinstance(zt, np.ndarray) and zt.dtype == np.float64
        _close(zt, zj, 1e-10, "decay")
    rng = np.random.default_rng(3)
    m = len(levels[0])
    scale = 2.0 if plant == "chain" else 50.0
    for lens in ((T, T, T), (T, T - 2)):
        us = [scale * rng.random((k, m)) for k in lens]
        got = tsys.collect_actuated_trajectories(tp, Hf, us, 0.01)
        ref = jsys.collect_actuated_trajectories(jp, Hf, us, 0.01)
        for (zt, ut), (zj, uj) in zip(got, ref):
            assert np.array_equal(ut, uj) and zt.shape == (len(ut), 3)
            _close(zt, zj, 1e-10, "actuated")


def test_csv_exports_are_the_jax_packages(tmp_path):
    """export_decays_csv and sim_pkl_to_csv write the same files."""
    rng = np.random.default_rng(4)
    decays = [(0.01 * np.arange(5), rng.normal(size=(5, 3)))
              for _ in range(2)]
    pt = tsys.export_decays_csv(decays, str(tmp_path / "t"))
    pj = jsys.export_decays_csv(decays, str(tmp_path / "j"))
    assert [os.path.basename(p) for p in pt] == [os.path.basename(p)
                                                 for p in pj]
    for a, b in zip(pt, pj):
        assert open(a).read() == open(b).read()
    sim = {"t": 0.01 * np.arange(6), "u": rng.normal(size=(6, 2)),
           "z": rng.normal(size=(6, 3)), "z_hat": np.zeros((0, 3))}
    path = str(tmp_path / "run_sim.pkl")
    tsave(path, sim)
    got = tsys.sim_pkl_to_csv(path, str(tmp_path / "ct"))
    ref = jsys.sim_pkl_to_csv(path, str(tmp_path / "cj"))
    assert sorted(got) == sorted(ref) == ["t", "u", "z"]
    for k in got:
        assert open(got[k]).read() == open(ref[k]).read()


def _runs(tmp_path):
    """Two controllers' runs pickled by each package's save_data, with
    solve times (one None, as a skipped replan logs it) in one."""
    rng = np.random.default_rng(5)
    t = 0.01 * np.arange(300)
    base = np.stack([np.sin(t), np.cos(t), 0.1 * t], axis=1)
    runs = {"tpwl": {"t": t, "z": base + 0.01 * rng.normal(size=base.shape),
                     "u": rng.random((300, 4)),
                     "info": {"solve_times": list(rng.random(20) * 0.01)}},
            "rompc": {"t": t, "z": base + 0.05 * rng.normal(size=base.shape),
                      "u": rng.random((300, 4)), "info": {}}}
    paths = {}
    for p, save in (("t", tsave), ("j", jsave)):
        for k, v in runs.items():
            paths[p, k] = str(tmp_path / f"{p}_{k}_sim.pkl")
            save(paths[p, k], v)
    return t, base, paths


def test_metric_table_is_the_same_from_either_packages_pickles(tmp_path):
    """load_run, tracking_mse and solve_time_stats of each package on each
    package's pickles: identical numbers; with matplotlib, compare_runs'
    table (figures written) identical too."""
    t_t, z_t, paths = _runs(tmp_path)
    tables = []
    for mod in (tbc, jbc):
        for p in "tj":
            runs = {k: mod.load_run(paths[p, k], t_start=0.5)
                    for k in ("tpwl", "rompc")}
            tables.append({k: (mod.tracking_mse(r, t_t, z_t, dims=[0, 1]),
                               mod.solve_time_stats(r))
                           for k, r in runs.items()})
    assert all(tb == tables[0] for tb in tables[1:])
    assert tables[0]["rompc"][1] is None and tables[0]["tpwl"][1]["n"] == 20
    pytest.importorskip("matplotlib")
    out = []
    for mod, p in ((tbc, "j"), (jbc, "t")):
        runs = {k: mod.load_run(paths[p, k], t_start=0.5)
                for k in ("tpwl", "rompc")}
        prefix = str(tmp_path / f"cmp_{p}")
        out.append(mod.compare_runs(runs, t_t, z_t, dims=(0, 1),
                                    realtime_limit=0.02,
                                    save_prefix=prefix))
        for suffix in ("_xy.png", "_t.png", "_solvetimes.png"):
            assert os.path.getsize(prefix + suffix) > 0
    assert out[0] == out[1]


def test_plots_draw_the_jax_packages_lines(tmp_path):
    """plot_tracking, plot_inputs, plot_solve_times and
    plot_trajectory_3d: the same lines (x and y data) in the same axes,
    and the files written."""
    pytest.importorskip("matplotlib")
    from soft_robot_control_tpu.tasks import plotting as jplot
    from soft_robot_control_tpu_torch.tasks import plotting as tplot

    rng = np.random.default_rng(6)
    sim = {"t": 0.01 * np.arange(50), "z": rng.normal(size=(50, 2)),
           "u": rng.random((50, 3)),
           "info": {"solve_times": list(rng.random(5)) + [None]}}
    t_t, z_t = 0.02 * np.arange(40), rng.normal(size=(40, 2))

    def lines(fig):
        return [[ln.get_xydata().tolist() for ln in ax.lines]
                for ax in fig.axes]

    calls = (("plot_tracking", (sim, t_t, z_t), {}),
             ("plot_inputs", (sim,), {}),
             ("plot_solve_times", (sim,), dict(realtime_limit=0.5)),
             ("plot_trajectory_3d", ([sim["z"], z_t], ["a", "b"]), {}))
    for name, args, kw in calls:
        figs = []
        for p, mod in (("t", tplot), ("j", jplot)):
            path = str(tmp_path / f"{name}_{p}.png")
            figs.append(getattr(mod, name)(*args, save_path=path, **kw))
            assert os.path.getsize(path) > 0
        if name != "plot_trajectory_3d":
            assert lines(figs[0]) == lines(figs[1]), name
