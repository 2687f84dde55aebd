"""The campaigns' artifact gates on the port: tests/test_campaign_artifacts.py
(the Diamond) and tests/test_trunk_campaign_artifacts.py (the Trunk) as
checks of a run's own output directory, JAX-free, at the same limits.

Each gate reads the directory it is given and raises AssertionError when a
limit is passed; a gate whose artifact is absent passes, as its test
skips. `diamond_gates(d)` and `trunk_gates(d)` run a file's gates and
return the failures as strings. The Diamond gates skip, as their file
does, without the dictionary, which every run that calls them holds in
its --out; the Trunk gates key each on its own artifact, since the JAX
file's skip on the TPWL summary would leave a Trunk SSM run in a
directory of its own unjudged. `enforce(...)` is the campaign scripts'
end: the gates on the run's directory and, on a failure, the run's
artifacts quarantined (utils/gatekeeper.py) and `GatesFailed` raised. The
gates run on the CPU in float64, as the gate tests do."""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

# the reference meshes' node counts, which the gates name
DIAMOND_MESH_NODES = 1628
TRUNK_MESH_NODES = 709
DIST_PARAMS = {"dist_weights": {"q": 10.0, "v": 1.0}}


class GatesFailed(SystemExit):
    """A campaign run failed its gates: its artifacts are quarantined and
    the script exits with code 1. Carries the failures, the run's summary
    and where each quarantined artifact went."""

    def __init__(self, fails, summary, moved):
        super().__init__(1)
        self.fails, self.summary, self.moved = fails, summary, moved

    def __str__(self):
        return f"campaign gates failed: {self.fails}"


def _json(path):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# tests/test_campaign_artifacts.py


def campaign_pod_layout(d):
    """:21: the POD basis of the 1628-node mesh, r >= 20, orthonormal."""
    from soft_robot_control_tpu_torch.rom.pod import load_POD
    from soft_robot_control_tpu_torch.utils.device import to_numpy

    rom = load_POD(os.path.join(d, "pod_model.pkl"), device="cpu")
    assert rom.full_dim == 3 * DIAMOND_MESH_NODES, rom.full_dim
    assert rom.rom_dim >= 20, rom.rom_dim
    U = to_numpy(rom.U)
    np.testing.assert_allclose(U.T @ U, np.eye(rom.rom_dim), atol=1e-4)


def campaign_tpwl_dict_discrete_native(d):
    """:32: the dictionary has at least 200 points, discrete at dt 0.01
    (pre_discretize there is the identity), and one window of the
    condensed BatchMPC on it is finite."""
    import torch

    from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
    from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
    from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
    from soft_robot_control_tpu_torch.sim.measurement import linearModel
    from soft_robot_control_tpu_torch.tasks.demo import demo_targets

    n = DIAMOND_MESH_NODES
    Hf = linearModel([1354], n, vel=False).C_dense()
    model = from_tpwl_dict(os.path.join(d, "tpwl_model_snapshots.pkl"),
                           params=DIST_PARAMS, Hf=Hf, discr_method="be",
                           device="cpu")
    assert model.num_points >= 200, model.num_points
    assert model.A_d is not None and model.pre_discretized_dt == 0.01
    assert model.pre_discretize(0.01) is model
    Cf = linearModel([1354, 726, 139, 1445, 729], n).C_dense()
    model = model.set_measurement_model(Cf)
    nz = model.H.shape[0]
    mpc = BatchMPC(model, 100.0 * np.eye(nz), 1e-3 * np.eye(4), N=4,
                   dt=0.01, N_replan=2, qp_iters=30, scp_iters=1,
                   dtype=torch.float64, x_step="kinv",
                   formulation="condensed",
                   U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
                   W=1e-2 * np.eye(model.state_dim),
                   V=1e-4 * np.eye(model.C.shape[0]), device="cpu")
    zt = demo_targets(model, 1, 2, 4, 0.01, batch=1)[0]
    x0 = np.zeros(model.state_dim)
    logs = mpc.build(1)(x0, x0, zt)
    assert np.isfinite(logs["z"].numpy()).all()


def campaign_rest_matches_pod_ref(d):
    """:67: rest.pkl's rest positions are the POD reference (1e-5)."""
    from soft_robot_control_tpu_torch.rom.pod import load_POD
    from soft_robot_control_tpu_torch.utils.device import to_numpy

    with open(os.path.join(d, "rest.pkl"), "rb") as f:
        rest = pickle.load(f)
    rom = load_POD(os.path.join(d, "pod_model.pkl"), device="cpu")
    np.testing.assert_allclose(np.asarray(rest["rest"]),
                               to_numpy(rom.q_ref), atol=1e-5)


def diamond_ssm_artifact_stable_and_tracks(d):
    """:79: the Diamond SSM (6 states, 4 inputs) contracts an unforced
    decay from 3 mm to under half in 200 steps; its closed loop tracks
    under 5 mm with a held-out error under 0.2."""
    import torch

    from soft_robot_control_tpu_torch.models import ssm as ssm_mod

    art = os.path.join(d, "diamond_SSM_model.mat")
    if not os.path.exists(art):
        return
    model = ssm_mod.from_mat(art, None, discrete=False, discr_method="be",
                             device="cpu")
    assert model.state_dim == 6 and model.input_dim == 4
    x0 = model.observed_to_reduced(torch.as_tensor(
        np.concatenate([3.0 * np.ones(3), np.zeros(3)]),
        dtype=model.dtype))
    xs, _ = model.rollout(x0, torch.zeros((200, 4), dtype=model.dtype),
                          0.01)
    n0 = float(torch.linalg.norm(xs[0]))
    nT = float(torch.linalg.norm(xs[-1]))
    assert np.isfinite(nT) and nT < 0.5 * n0, (n0, nT)
    res = os.path.join(d, "diamond_ssm_mpc.json")
    if os.path.exists(res):
        r = _json(res)
        assert r["tracking_rmse_mm"] < 5.0, r
        assert r["held_out_rel"] < 0.2, r


def diamond_tpwl_gusto_closed_loop_gates(d):
    """:108: the TPWL GuSTO loop tracks under 10 mm; a mean solve under
    the 300 ms workstation budget, with the flown budget declared."""
    res = os.path.join(d, "diamond_tpwl_campaign.json")
    if not os.path.exists(res):
        return
    r = _json(res)
    assert r["scp_rmse_mm"] < 10.0, r
    if r.get("scp_solve_ms_mean") is not None:
        assert r["scp_solve_ms_mean"] < 300.0, r
        assert "mpc_replan_budget_ms" in r, r


def diamond_baselines_gates(d):
    """:137: ROMPC under 5 mm, Koopman under 10 mm, each leg's mean solve
    under 100 ms."""
    res = os.path.join(d, "diamond_baselines.json")
    if not os.path.exists(res):
        return
    r = _json(res)
    assert r["rompc"]["tracking_rmse_mm"] < 5.0, r
    assert r["koopman"]["tracking_rmse_mm"] < 10.0, r
    for leg in ("rompc", "koopman"):
        ms = r[leg].get("solve_ms_mean")
        if ms is not None:
            assert ms < 100.0, (leg, r)


def realtime_latency_gates(d):
    """:159: realtime_mpc.json (examples/realtime_mpc.py's gates)."""
    from soft_robot_control_tpu_torch.examples.realtime_mpc import (
        realtime_gates)

    res = os.path.join(d, "realtime_mpc.json")
    if os.path.exists(res):
        fails = realtime_gates(_json(res))
        assert not fails, fails


def noisy_batch_mpc_gates(d):
    """:179: noisy_batch_mpc.json (examples/noisy_batch_mpc_campaign.py's
    gates)."""
    from soft_robot_control_tpu_torch.examples.noisy_batch_mpc_campaign \
        import noisy_gates

    res = os.path.join(d, "noisy_batch_mpc.json")
    if os.path.exists(res):
        fails = noisy_gates(_json(res))
        assert not fails, fails


DIAMOND_GATES = (campaign_pod_layout, campaign_tpwl_dict_discrete_native,
                 campaign_rest_matches_pod_ref,
                 diamond_ssm_artifact_stable_and_tracks,
                 diamond_tpwl_gusto_closed_loop_gates,
                 diamond_baselines_gates, realtime_latency_gates,
                 noisy_batch_mpc_gates)


# ---------------------------------------------------------------------------
# tests/test_trunk_campaign_artifacts.py


def trunk_campaign_quality_gates(d):
    """:22: GuSTO under 18 mm, iLQR under 14 mm, at most 50 plan rejects,
    tip spans under 40/40/25 mm, a mean solve under 300 ms with the flown
    budget declared."""
    p = os.path.join(d, "trunk_tpwl_campaign.json")
    if not os.path.exists(p):
        return
    r = _json(p)
    assert r["scp_rmse_mm"] < 18.0, r
    assert r["ilqr_rmse_mm"] < 14.0, r
    if "scp_plan_rejects" in r:
        assert r["scp_plan_rejects"] <= 50, r
    if "scp_tip_span_mm" in r:
        sx, sy, sz = r["scp_tip_span_mm"]
        assert sx < 40.0 and sy < 40.0 and sz < 25.0, r
    if r.get("scp_solve_ms_mean") is not None:
        assert r["scp_solve_ms_mean"] < 300.0, r
        assert "mpc_replan_budget_ms" in r, r


def trunk_campaign_sims_loadable(d, name):
    """:50: a closed loop's pickle: 3 outputs a step, finite, and the tip
    swept more than 10 mm in x."""
    p = os.path.join(d, name)
    if not os.path.exists(p):
        return
    with open(p, "rb") as f:
        sim = pickle.load(f)
    z = np.asarray(sim["z"])
    t = np.asarray(sim["t"])
    assert z.shape[1] == 3 and len(t) == len(z)
    assert np.isfinite(z).all()
    assert np.ptp(z[:, 0]) > 10.0


def trunk_tpwl_dictionary_loads_discrete(d):
    """:64: the Trunk dictionary loads with at least 100 points, discrete."""
    from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
    from soft_robot_control_tpu_torch.sim.measurement import linearModel

    p = os.path.join(d, "tpwl_model_snapshots.pkl")
    if not os.path.exists(p):
        return
    Hf = linearModel([51], TRUNK_MESH_NODES, vel=False).C_dense()
    model = from_tpwl_dict(p, params=DIST_PARAMS, Hf=Hf, discr_method="be",
                           device="cpu")
    assert model.num_points >= 100, model.num_points
    assert model.A_d is not None


def trunk_ssm_mpc_gates(d):
    """:78: the Trunk SSM loop tracks under 8 mm inside a 300 mN
    envelope."""
    p = os.path.join(d, "trunk_ssm_mpc.json")
    if not os.path.exists(p):
        return
    r = _json(p)
    assert r["tracking_rmse_mm"] < 8.0, r
    assert r["u_envelope_mN"] <= 300.0, r


TRUNK_GATES = (trunk_campaign_quality_gates,
               lambda d: trunk_campaign_sims_loadable(d, "scp_fig8_sim.pkl"),
               lambda d: trunk_campaign_sims_loadable(d, "ilqr_fig8_sim.pkl"),
               trunk_tpwl_dictionary_loads_discrete, trunk_ssm_mpc_gates)
TRUNK_GATE_NAMES = ("trunk_campaign_quality_gates",
                    "trunk_campaign_sims_loadable[scp_fig8_sim.pkl]",
                    "trunk_campaign_sims_loadable[ilqr_fig8_sim.pkl]",
                    "trunk_tpwl_dictionary_loads_discrete",
                    "trunk_ssm_mpc_gates")


def _run(gates, names, d):
    fails = []
    for gate, name in zip(gates, names):
        try:
            gate(d)
        except Exception as e:  # a failed gate, as pytest reports it
            fails.append(f"{name}: {type(e).__name__}: {e}"[:400])
    return fails


def diamond_gates(d, k=None):
    """The Diamond gates on directory d (those whose name holds k, as
    pytest -k selects): the failures. Skipped, as the file is, without
    the dictionary."""
    if not os.path.exists(os.path.join(d, "tpwl_model_snapshots.pkl")):
        return []
    gates = [g for g in DIAMOND_GATES if k is None or k in g.__name__]
    return _run(gates, [g.__name__ for g in gates], d)


def trunk_gates(d):
    """The Trunk gates on directory d: the failures. Each gate reads its
    own artifact and passes without it (the JAX file's module-level skip
    on the TPWL summary would leave a Trunk SSM run unjudged)."""
    return _run(TRUNK_GATES, TRUNK_GATE_NAMES, d)


def enforce(gates, out_dir, artifacts, summary, log=print):
    """The gates' failures on out_dir; on any, the run's artifacts are
    quarantined into out_dir/rejected/ and GatesFailed is raised."""
    from soft_robot_control_tpu_torch.utils.gatekeeper import quarantine

    fails = gates(out_dir)
    if not fails:
        log("campaign gates hold")
        return
    log("ARTIFACT GATES FAILED: " + "; ".join(fails))
    raise GatesFailed(fails, summary, quarantine(artifacts, out_dir))
