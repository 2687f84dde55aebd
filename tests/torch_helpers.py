"""Shared fixtures of the PyTorch-port parity tests.

The port runs on the CPU here through its kernels' plain versions, in f64,
single-threaded: the JAX runtime's own thread pool works in the same
process, and two pools spinning on the same cores slow both by orders of
magnitude. Inputs are made with numpy and handed to both packages.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGN = os.path.join(REPO, "examples", "diamond_tet",
                        "tpwl_model_snapshots.pkl")
CAMPAIGN_PARAMS = {"dist_weights": {"q": 10.0, "v": 1.0}}
DICT_KEYS = ("q", "v", "u", "A_c", "B_c", "d_c", "A_d", "B_d", "d_d")
# the committed SSM artifacts: bench.py's trunk model and the Diamond's
SSM_ARTIFACTS = {
    "trunk": os.path.join(REPO, "examples", "trunk_tet",
                          "trunk_SSM_model.mat"),
    "diamond": os.path.join(REPO, "examples", "diamond_tet",
                            "diamond_SSM_model.mat")}


def campaign_output_maps():
    """Cf (y: 5 nodes, pos + vel) and Hf (z: one node's position) of the
    Diamond campaign, as bench.py builds them."""
    from soft_robot_control_tpu_torch.sim.measurement import linearModel

    Cf = linearModel([1354, 726, 139, 1445, 729], 1628).C_dense()
    Hf = linearModel([1354], 1628, vel=False).C_dense()
    return Cf, Hf


def campaign_dict(points=None):
    """The committed Diamond campaign TPWL dictionary in float64, or the
    subset of it at the indices `points`."""
    from soft_robot_control_tpu_torch.utils.io import load_data

    data = load_data(CAMPAIGN)
    sel = slice(None) if points is None else np.asarray(points)
    return {k: (np.asarray(v)[sel].astype(np.float64) if k in DICT_KEYS
                else v) for k, v in data.items()}


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def ssm_targets(B, n_win, N=3, N_replan=2, dt=0.02, seed=7):
    """bench.py section 5's targets: a 2 mm circle through the start in
    the tip's (x, y), one phase a loop from default_rng(seed), in shifted
    coordinates, windowed (B, n_win, N+1, 6)."""
    from soft_robot_control_tpu_torch.control.batch_mpc import window_targets

    T = n_win * N_replan + N + 1
    ts = dt * np.arange(T)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        ph = rng.uniform(0, 2 * np.pi)
        zz = np.zeros((T, 6))
        zz[:, 0] = 2.0 * np.cos(2 * np.pi * ts / 6.0 + ph) - 2.0 * np.cos(ph)
        zz[:, 1] = 2.0 * np.sin(2 * np.pi * ts / 6.0 + ph) - 2.0 * np.sin(ph)
        out.append(window_targets(zz, n_win, N_replan, N))
    return np.stack(out)


CHAIN_FIXTURE = os.path.join(REPO, "tests", "golden",
                             "chain_pipeline_arrays.npz")
GOLDEN_CHAIN = os.path.join(REPO, "tests", "golden", "closed_loop_chain.npz")


def chain_fixture(device="cpu"):
    """The committed chain pipeline of tests/helpers.py:chain_pipeline(
    n_nodes=10, n_cables=4, dt=0.02, threshold=0.5) as the port's objects
    on `device`: (plant, model pre-discretized at dt=0.02, Hf, Cf, X, u),
    with X the snapshot trajectory and u its inputs."""
    from soft_robot_control_tpu_torch.models.convert import (
        model_from_arrays, surrogate_from_arrays, unflatten_arrays)

    with np.load(CHAIN_FIXTURE) as f:
        a = unflatten_arrays(f)
    return (surrogate_from_arrays(a["plant"], device=device),
            model_from_arrays(a["tpwl"], device=device), a["Hf"], a["Cf"],
            a["X"], a["u"])


class TLin:
    """An output or measurement model z = M x on tensors."""

    def __init__(self, M, device="cpu"):
        self.M = torch.as_tensor(np.array(M), device=device)

    def evaluate(self, x, generator=None):
        return self.M.to(x.dtype) @ x


def golden_loop(device="cpu"):
    """tests/test_golden.py:_run on the port: the chain fixture, TPWLGuSTO
    behind GuSTOService(N=5, dt=0.04, Qz=200, R=1e-5 I, max_gusto_iters=2,
    convg_thresh=1e-2), the EKF with the recipe's W and V, scp(N_replan=2,
    delay=0.5, mpc=True), 3 s at dt=0.02, in f64 on `device`. Returns
    (z, u, sim data)."""
    from soft_robot_control_tpu_torch.control.mpc import scp
    from soft_robot_control_tpu_torch.control.service import GuSTOService
    from soft_robot_control_tpu_torch.core.types import QuadraticCost
    from soft_robot_control_tpu_torch.estimators.ekf import (
        DiscreteEKFObserver)
    from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
    from soft_robot_control_tpu_torch.sim.closed_loop import run_closed_loop
    from soft_robot_control_tpu_torch.utils.device import to_numpy

    dt = 0.02
    plant, model, Hf, Cf, _, _ = chain_fixture(device)
    nz = model.H.shape[0]
    Qz, R = 200.0 * np.eye(nz), 1e-5 * np.eye(plant.input_dim)
    t_t = np.arange(0.0, 8.0, dt)
    z_eq = float((to_numpy(plant.x_rest()) @ Hf.T)[0])
    z_t = (z_eq + 0.05 * np.sin(2 * np.pi * t_t / 3.0))[:, None]
    z_solver = to_numpy(model.zfyf_to_zy(zf=z_t))
    x0 = to_numpy(model.rom.project_x(model.rom.x_ref))
    service = GuSTOService(TPWLGuSTO(model), 5, 2 * dt, Qz, R, x0, t=t_t,
                           z=z_solver, max_gusto_iters=2, convg_thresh=1e-2,
                           verbose=0)
    H = to_numpy(model.H)
    cost = QuadraticCost(Q=H.T @ Qz @ H, R=R)
    dx_char = to_numpy(model.get_characteristic_dx(dt))
    observer = DiscreteEKFObserver(model, W=np.diag(dx_char + 1e-8),
                                   V=0.1 * np.eye(Cf.shape[0]))
    ctrl = scp(model, cost, dt, N_replan=2, observer=observer, delay=0.5,
               wait=True, solver_service=service, mpc=True)
    sim = run_closed_loop(plant, ctrl, sim_duration=3.0, dt=dt,
                          measurement_model=TLin(Cf, device),
                          output_model=TLin(Hf, device))
    return sim["z"], sim["u"], sim


class LiftedPlant:
    """A TPWL dictionary lifted to the full state through its POD basis,
    as a test plant: x+ = lift(update_state(project(x), u, dt))."""

    def __init__(self, model):
        self.m = model
        self.input_dim = model.input_dim
        self.dtype = torch.float64

    @property
    def device(self):
        return self.m.device

    def x_rest(self):
        return self.m.rom.x_ref

    def step(self, x, u, dt):
        rom = self.m.rom
        return rom.lift_x(self.m.update_state(rom.project_x(x),
                                              u.to(self.m.q.dtype), dt))


# the Diamond campaign's real-time MPC (examples/diamond_tet_campaign.py:
# 158-190, tasks/recipes.py:212-268): the solver's settings, with GuSTO's
# polish step off (its active-set guess reads the signs of duals that are
# rounding noise at R = 1e-5 I, so two runtimes can take different plans)
CAMPAIGN_DT = 0.01
CAMPAIGN_GUSTO = dict(max_gusto_iters=0, convg_thresh=1e-2,
                      is_tr_active=False, locp_backend="condensed",
                      oneshot_iters=2, plan_bound=60.0, polish=False)


def campaign_target(z_eq):
    """The campaign's figure-8 about the rest output z_eq: (t, z)."""
    tt = np.linspace(0, 10.0, 1000)
    th = np.linspace(0, 2 * np.pi, 1000)
    z = np.tile(np.asarray(z_eq, float), (1000, 1))
    z[:, 0] += -20.0 * np.sin(th) - 5.5
    z[:, 1] += 10.0 * np.sin(2 * th) + 1.5
    return tt, z


def campaign_scp(model, N=10):
    """The campaign's scp controller on a TPWL model (with its output and
    measurement maps): GuSTOService(TPWLGuSTO, N, dt=0.01, Qz=diag(100,
    100, 0), R=1e-5 I, U=[0, 1500]^4, CAMPAIGN_GUSTO), the EKF with
    W = diag(dx_char + 1e-8), V = 0.1 I, scp(N_replan=2, mpc=True,
    feedback=True), a 2-tick delay."""
    from soft_robot_control_tpu_torch.control.mpc import scp
    from soft_robot_control_tpu_torch.control.service import GuSTOService
    from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
    from soft_robot_control_tpu_torch.core.types import QuadraticCost
    from soft_robot_control_tpu_torch.estimators.ekf import (
        DiscreteEKFObserver)
    from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
    from soft_robot_control_tpu_torch.utils.device import to_numpy

    dt = CAMPAIGN_DT
    Qz, R = np.diag([100.0, 100.0, 0.0]), 1e-5 * np.eye(4)
    tt, z_t = campaign_target(to_numpy(model.z_ref))
    x0 = to_numpy(model.rom.project_x(model.rom.x_ref)).astype(float)
    svc = GuSTOService(TPWLGuSTO(model), N, dt, Qz, R, x0, t=tt,
                       z=to_numpy(model.zfyf_to_zy(zf=z_t)),
                       U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
                       **CAMPAIGN_GUSTO)
    H = to_numpy(model.H).astype(float)
    dx = to_numpy(model.get_characteristic_dx(dt)).astype(float)
    obs = DiscreteEKFObserver(model, W=np.diag(dx + 1e-8),
                              V=0.1 * np.eye(model.C.shape[0]))
    return scp(model, QuadraticCost(Q=H.T @ Qz @ H, R=R), dt, N_replan=2,
               observer=obs, delay=0.02, wait=True, solver_service=svc,
               mpc=True, feedback=True)
