"""The noisy-measurement batched MPC+EKF campaign: bench.py's
quality-gated condensed configuration at B=1024 on the campaign
dictionary, driven at several measurement-noise levels with the EKF on,
against dynamically feasible targets: the twin of
examples/noisy_batch_mpc_campaign.py on the port.

    python -m soft_robot_control_tpu_torch.examples.noisy_batch_mpc_campaign \
        [--out runs/noisy_batch_mpc.json] [--device cpu]

It writes {noise_std -> relative tracking error} to `--out` and fails when
tests/test_campaign_artifacts.py's noisy-campaign gates do not hold on it.
The measurement noise is drawn from a torch generator seeded with 1, so its
draws are not the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from soft_robot_control_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CAMPAIGN = os.path.join(REPO, "examples", "diamond_tet",
                        "tpwl_model_snapshots.pkl")
NOISE_LEVELS = (0.0, 0.1, 0.5, 1.0)
# tests/test_campaign_artifacts.py's noisy-campaign gates: noise level ->
# the largest relative tracking error allowed
GATES = {0.0: 0.05, 0.1: 0.08, 1.0: 0.5}


def load_bench_model(dtype=torch.float32, device="cuda"):
    """bench.py's model: the committed campaign dictionary with its output
    (node 1354) and measurement (5 nodes) maps when it exists, else the
    synthetic model at P=320. Returns (model in dtype, dt, source)."""
    from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
    from soft_robot_control_tpu_torch.sim.measurement import linearModel
    from soft_robot_control_tpu_torch.tasks.demo import make_demo_tpwl

    if os.path.exists(CAMPAIGN):
        Cf = linearModel([1354, 726, 139, 1445, 729], 1628).C_dense()
        Hf = linearModel([1354], 1628, vel=False).C_dense()
        model = from_tpwl_dict(
            CAMPAIGN, params={"dist_weights": {"q": 10.0, "v": 1.0}},
            Cf=Cf, Hf=Hf, discr_method="be", device=device)
        dt = (float(model.pre_discretized_dt)
              if model.pre_discretized_dt else 0.01)
        src = (f"diamond_tet_campaign(P={model.num_points}, "
               f"r={model.rom.rom_dim}, n_f=9768)")
    else:
        model = make_demo_tpwl(r=21, P=320, m=4, nz=6, nf=64,
                               dtype=np.float32, device=device)
        dt = 0.02
        src = f"synthetic(P={model.num_points}, r=21)"
    return model.to(dtype=dtype), dt, src


def campaign_mpc(model, dt):
    """bench.py's quality-gated condensed BatchMPC on the model's device
    and in its dtype: N=5, N_replan=2, 100 ADMM iterations in 4 rho stages,
    6 Ruiz iterations, Qz = 100 I, R = 1e-5 I, cables in [0, 1500] mN."""
    from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
    from soft_robot_control_tpu_torch.core.constraints import HyperRectangle

    nz, m_in = model.H.shape[0], model.input_dim
    U = HyperRectangle(1500.0 * np.ones(m_in), np.zeros(m_in))
    return BatchMPC(model, 100.0 * np.eye(nz), 1e-5 * np.eye(m_in), N=5,
                    dt=dt, N_replan=2, qp_iters=100, scp_iters=1,
                    dtype=model.q.dtype, x_step="kinv",
                    formulation="condensed", U=U, rho_stages=4,
                    scaling_iters=6, W=1e-2 * np.eye(model.state_dim),
                    V=1e-4 * np.eye(model.C.shape[0]), device=model.device)


def feasible_targets(mpc, B, n_win, seed=11):
    """The model's own z-response to smooth admissible cable inputs from
    rest (the bench's quality targets), windowed (B, n_win, N+1, n_z), and
    the executed entries 1..N_replan of each window (B, n_win*N_replan,
    n_z), numpy."""
    from soft_robot_control_tpu_torch.control.batch_mpc import window_targets
    from soft_robot_control_tpu_torch.models.tpwl import rollout_batch

    m, dt = mpc.model, mpc.dt
    N, N_replan, m_in = mpc.N, mpc.N_replan, m.input_dim
    T_q = n_win * N_replan + N + 1
    rng = np.random.default_rng(seed)
    tq = dt * np.arange(T_q + 1)
    u_ref = 0.5 * 1500.0 * (1.0 + np.sin(
        2 * np.pi * tq[None, :, None] / 4.0
        + rng.uniform(0, 2 * np.pi, size=(B, 1, m_in))))
    X = rollout_batch(m, torch.zeros((B, m.state_dim), dtype=mpc.dtype,
                                     device=mpc.device),
                      torch.as_tensor(u_ref, dtype=mpc.dtype,
                                      device=mpc.device), dt)
    zq = (X @ m.H.T + m.z_ref).cpu().numpy()
    zt = np.stack([window_targets(zq[b, :T_q], n_win, N_replan, N)
                   for b in range(B)])
    return zt, zt[:, :, 1:N_replan + 1, :].reshape(B, n_win * N_replan, -1)


def rel_tracking(z, zt_exec):
    """The bench's relative tracking error of logged z against the executed
    targets."""
    den = max(np.linalg.norm(zt_exec - zt_exec.mean(axis=(0, 1))), 1e-12)
    return float(np.linalg.norm(z - zt_exec) / den)


def sweep(model, dt, src, B=1024, n_win=4, noise_levels=NOISE_LEVELS,
          log=print):
    """The campaign on `model` (as load_bench_model gives it, on its device
    and in its dtype): one build_fused run a noise level (y = C x +
    noise_std N(0, I), draws from a generator seeded with 1), from rest.
    Returns the script's results dict."""
    t0 = time.time()
    dev = model.device
    log(f"[{time.time() - t0:6.1f}s] model: {src}; device {dev}")
    mpc = campaign_mpc(model, dt)
    zt, zt_exec = feasible_targets(mpc, B, n_win)
    x0 = torch.zeros((B, mpc.n_x), dtype=mpc.dtype, device=dev)
    results = {"model_source": src, "batch": B, "n_windows": n_win,
               "noise": {}}
    for noise_std in noise_levels:
        gen = torch.Generator(device=dev).manual_seed(1)
        logs = mpc.build_fused(n_win, noise_std=noise_std)(x0, x0, zt,
                                                             generator=gen)
        rel = rel_tracking(logs["z"].cpu().numpy(), zt_exec)
        results["noise"][str(noise_std)] = rel
        log(f"[{time.time() - t0:6.1f}s] noise_std={noise_std:>4}: rel "
            f"tracking err {rel:.4f}")
    return results


def noisy_gates(results) -> list:
    """tests/test_campaign_artifacts.py's noisy-campaign gates on a results
    dict: the list of those it fails."""
    noise = {float(k): v for k, v in results["noise"].items()}
    return [f"noise {k}: {noise[k]} > {lim}" for k, lim in GATES.items()
            if not noise[k] <= lim]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=os.path.join("runs",
                                                 "noisy_batch_mpc.json"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    results = sweep(*load_bench_model(torch.float32,
                                      resolve_device(args.device)))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"saved {args.out}")
    fails = noisy_gates(results)
    if fails:
        raise SystemExit(f"noisy-campaign gates failed: {fails}")
    print("noisy-campaign gates hold")
    return results


if __name__ == "__main__":
    main()
