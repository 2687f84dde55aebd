"""The port's entry points that run on committed data against the JAX
package's scripts, f64 on the CPU: the `launch` twin's printed JSON for the
surrogate chain and its tet robots' error while their meshes are absent;
one window of the real-time controller and the batched serving loop split
over a dp=4 mesh, against the JAX BatchMPC on the same demo model; the
noisy campaign's construction and its noise-free error; the Diamond
pipeline and the Dubins demo on the port."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import launch as jax_launch
from torch_helpers import CAMPAIGN_PARAMS, campaign_dict, campaign_output_maps

from soft_robot_control_tpu.control.batch_mpc import BatchMPC as JaxMPC
from soft_robot_control_tpu.control.batch_mpc import window_targets
from soft_robot_control_tpu.models.tpwl import from_tpwl_dict as jax_from
from soft_robot_control_tpu.models.tpwl import rollout_batch as jax_rollout
from soft_robot_control_tpu.tasks.demo import demo_targets as jax_targets
from soft_robot_control_tpu.tasks.demo import make_demo_tpwl as jax_demo
from soft_robot_control_tpu_torch import launch
from soft_robot_control_tpu_torch.examples import (batched_serving,
                                                   diamond_pipeline,
                                                   dubins_gusto,
                                                   noisy_batch_mpc_campaign,
                                                   realtime_mpc)
from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict

CHAIN = [("collect_pod_data", []), ("compute_pod_basis", []),
         ("collect_tpwl_data", []), ("tpwl_check", []),
         ("run_scp", ["--duration", "1.5"])]


def test_launch_prints_the_jax_launchers_json(tmp_path, capsys):
    """The surrogate Diamond's chain, recipe by recipe: the same keys, the
    same counts, the rollout's and the loop's MSE to 1e-9 of their value;
    solve times are wall clocks, so only their keys and count agree."""
    for recipe, extra in CHAIN:
        jax_launch.main(["diamond", recipe, "--save-dir",
                         str(tmp_path / "jax"), "--platform", "cpu"] + extra)
        ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        got = launch.main(["diamond", recipe, "--save-dir",
                           str(tmp_path / "port"), "--device", "cpu"] + extra)
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == got and set(got) == set(ref), recipe
        for k, v in ref.items():
            if k == "solve_times":
                assert set(got[k]) == set(v)
                assert got[k]["count"] == v["count"]
            elif isinstance(v, int):
                assert got[k] == v, (recipe, k)
            else:
                assert abs(got[k] - v) <= 1e-9 * abs(v), (recipe, k)
    assert os.path.exists(tmp_path / "port" / "tpwl_model_snapshots.pkl")


@pytest.mark.parametrize("robot", ["diamond_tet", "trunk_tet"])
def test_tet_robots_need_their_meshes(tmp_path, robot):
    """While the reference meshes are absent, both launchers fail on the
    mesh file."""
    with pytest.raises(FileNotFoundError):
        jax_launch.get_robot(robot, 0.01)
    with pytest.raises(FileNotFoundError, match="mesh"):
        launch.main([robot, "collect_pod_data", "--save-dir",
                     str(tmp_path), "--device", "cpu"])


# The scripts build the demo model in float32 and each package discretizes
# it so before the loop casts it to f64: the two ZOHs differ by an f32 ulp
# (A_d up to 1.2e-6, z_ref 2.4e-7), which the logs carry at up to 4e-7
DEMO_ATOL = 1e-5


def _demo_mpcs(mpc_kw, formulation="sparse"):
    """Both packages' BatchMPC on make_demo_tpwl(r=21, P=64, m=4, nz=6,
    nf=64) in f64."""
    jm = jax_demo(r=21, P=64, m=4, nz=6, nf=64, dtype=np.float32)
    jmpc = JaxMPC(jm, 100.0 * np.eye(6), 1e-3 * np.eye(4), dtype=jnp.float64,
                  formulation=formulation, W=1e-2 * np.eye(jm.state_dim),
                  V=1e-4 * np.eye(jm.C.shape[0]), **mpc_kw)
    return jm, jmpc


def test_realtime_window_matches_jax():
    """One window of realtime_mpc's demo controller (dt = 1/50, N=5,
    N_replan=1, 50 iterations through the single-QP kernel's M1 x-step)
    against the JAX script's BatchMPC on the Cholesky x-step, the same
    iteration (the JAX single-QP Pallas kernel rounds its mat-vecs to
    f32), within DEMO_ATOL."""
    tmpc, dt, n_rep, hz = realtime_mpc.controller(None, 50.0, "cpu",
                                                  torch.float64)
    assert (dt, n_rep, hz) == (0.02, 1, 50.0) and tmpc.use_pallas
    jm, jmpc = _demo_mpcs(dict(N=5, dt=dt, N_replan=1, qp_iters=50))
    zt = jax_targets(jm, 1, 1, 5, dt, batch=1)[0]
    x0 = np.zeros(jm.state_dim)
    ref = jax.jit(jmpc.build(1))(jnp.asarray(x0), jnp.asarray(x0),
                                 jnp.asarray(zt), jax.random.PRNGKey(0))
    got = tmpc.build(1)(x0, x0, zt)
    for k in ("z", "u"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=DEMO_ATOL)


def test_realtime_summary_and_gates():
    """The paced loop's summary on the CPU has the JAX script's keys; the
    real-time gates of tests/test_campaign_artifacts.py read it (the
    loop's times on a loaded CPU may miss the deadline too, so only the
    campaign's gate is asserted on it)."""
    res, logs = realtime_mpc.measure(None, 50.0, 0.1, "cpu")
    assert res["n_steps"] == 5 and np.isfinite(logs["z"].numpy()).all()
    assert {"campaign", "hz", "deadline_ms", "rtt_ms_median",
            "total_ms_mean", "total_ms_p99", "compute_ms_mean",
            "compute_ms_p99", "compute_budget_misses", "n_steps",
            "device"} <= set(res)
    assert "campaign is not diamond" in realtime_mpc.realtime_gates(res)
    ok = dict(res, campaign="diamond", compute_ms_mean=1.0,
              compute_ms_p99=30.0, deadline_ms=20.0)
    assert realtime_mpc.realtime_gates(ok) == []
    assert len(realtime_mpc.realtime_gates(dict(ok, compute_ms_p99=40.0))) == 1


def test_batched_serving_mesh_matches_jax():
    """batched_serving at B=16 over a dp=4 mesh of the CPU against the JAX
    script's fused loop on the same demo model and targets (condensed, 50
    iterations) within DEMO_ATOL, and against its own run on one device:
    z within 1e-12, u within 1e-10 (a dp part's GEMMs round their rows
    apart from the whole batch's; the DARE gains amplify that in u)."""
    B, n_win = 16, 3
    out = batched_serving.serve(B, n_win, 4, "condensed", "cpu",
                                torch.float64, timed=1)
    one = batched_serving.serve(B, n_win, 0, "condensed", "cpu",
                                torch.float64, timed=1)
    jm, jmpc = _demo_mpcs(dict(N=5, dt=0.02, N_replan=2, qp_iters=50,
                               scp_iters=1, x_step="kinv"),
                          formulation="condensed")
    zt = jnp.asarray(jax_targets(jm, n_win, 2, 5, 0.02, batch=B))
    x0 = jnp.zeros((B, jm.state_dim))
    ref = jmpc.build_fused(n_win)(x0, x0, zt,
                                  jax.random.split(jax.random.PRNGKey(0), B))
    for k, atol in (("z", 1e-12), ("u", 1e-10)):
        got = out["logs"][k].numpy()
        np.testing.assert_allclose(got, np.asarray(ref[k]), rtol=0,
                                   atol=DEMO_ATOL)
        np.testing.assert_allclose(got, one["logs"][k].numpy(), rtol=0,
                                   atol=atol)
    assert out["windows_per_s"] > 0


def test_noisy_campaign_construction_matches_jax():
    """The loader is bench.py's (the same model source, dt and float32
    dictionary); the sweep's noise-free error at B=8 equals the JAX
    script's construction on 64 of the dictionary's points (every 17th, so
    that the per-point DARE stays cheap), f64; the gates pass the committed
    JAX figures and fail a loop that does not track."""
    from bench import load_bench_model as jax_loader

    jmodel, jdt, jsrc = jax_loader(np.float32)
    model, dt, src = noisy_batch_mpc_campaign.load_bench_model(
        torch.float32, "cpu")
    assert (dt, src) == (jdt, jsrc) and model.q.dtype == torch.float32
    for k in ("q", "A_d", "B_d", "d_d", "C", "H", "z_ref"):
        np.testing.assert_allclose(getattr(model, k).numpy(),
                                   np.asarray(getattr(jmodel, k)), rtol=1e-6,
                                   atol=1e-6)

    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    Cf, Hf = campaign_output_maps()
    kw = dict(params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf, discr_method="be")
    B, n_win, N, N_rep = 8, 4, 5, 2
    res = noisy_batch_mpc_campaign.sweep(
        from_tpwl_dict(data, device="cpu", **kw), 0.01, "subset", B=B,
        n_win=n_win, noise_levels=(0.0,), log=lambda s: None)

    # examples/noisy_batch_mpc_campaign.py's construction, in f64
    from soft_robot_control_tpu.core.constraints import HyperRectangle

    jm = jax_from(data, **kw)
    mpc = JaxMPC(jm, 100.0 * np.eye(3), 1e-5 * np.eye(4), N=N, dt=0.01,
                 N_replan=N_rep, qp_iters=100, scp_iters=1,
                 dtype=jnp.float64, x_step="kinv", formulation="condensed",
                 U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
                 rho_stages=4, scaling_iters=6,
                 W=1e-2 * np.eye(60), V=1e-4 * np.eye(30))
    jd = jm.pre_discretize(0.01)
    T_q = n_win * N_rep + N + 1
    rng = np.random.default_rng(11)
    tq = 0.01 * np.arange(T_q + 1)
    u_ref = 0.5 * 1500.0 * (1.0 + np.sin(
        2 * np.pi * tq[None, :, None] / 4.0
        + rng.uniform(0, 2 * np.pi, size=(B, 1, 4))))
    Xq = jax_rollout(jd, jnp.zeros((B, 60)), jnp.asarray(u_ref), 0.01)
    zq = np.asarray(Xq) @ np.asarray(jd.H).T + np.asarray(jd.z_ref)
    zt = np.stack([window_targets(zq[b, :T_q], n_win, N_rep, N)
                   for b in range(B)])
    x0 = jnp.zeros((B, 60))
    logs = mpc.build_fused(n_win)(x0, x0, jnp.asarray(zt),
                                  jax.random.split(jax.random.PRNGKey(1), B))
    zt_exec = zt[:, :, 1:N_rep + 1, :].reshape(B, n_win * N_rep, -1)
    den = np.linalg.norm(zt_exec - zt_exec.mean(axis=(0, 1)))
    ref = float(np.linalg.norm(np.asarray(logs["z"]) - zt_exec) / den)
    assert abs(res["noise"]["0.0"] - ref) <= 1e-9 * ref

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", "diamond_tet",
            "noisy_batch_mpc.json")) as f:
        committed = json.load(f)
    assert noisy_batch_mpc_campaign.noisy_gates(committed) == []
    bad = {"noise": {"0.0": 0.06, "0.1": 0.01, "0.5": 0.2, "1.0": 0.2}}
    assert len(noisy_batch_mpc_campaign.noisy_gates(bad)) == 1


def test_diamond_pipeline_runs_its_five_stages(tmp_path):
    """The pipeline twin on the CPU: its stages in order through the hook,
    a dictionary, a finite rollout check and a tracked closed loop."""
    seen = []

    def stage(name, fn):
        seen.append(name)
        return fn()

    out = diamond_pipeline.pipeline(str(tmp_path), "cpu", stage=stage,
                                    log=lambda s: None)
    assert seen == ["pod_data", "pod_basis", "tpwl_data", "rollout_check",
                    "run_scp"]
    assert out["model"].num_points > 10
    assert np.isfinite(out["check"]["mse"])
    assert np.isfinite(out["summary"]["tracking"]["mse"])


def test_dubins_gusto_reaches_its_target():
    """The Dubins demo on the CPU: the terminal state near (4, 5, 0) and
    the input rates within their 0.1 bound."""
    x, u, z, t_solve, iters = dubins_gusto.solve("cpu", verbose=0)
    assert x.shape == (51, 3) and u.shape == (50, 2)
    assert np.abs(x[-1, :2] - [4.0, 5.0]).max() < 0.2
    assert np.abs(np.diff(u, axis=0)).max() <= 0.1 + 1e-6
    assert iters >= 1 and t_solve > 0
