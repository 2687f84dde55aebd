"""Deterministic synthetic models at reference problem scales, and
synthetic tracking targets, for tests, demos and benchmarks."""

from __future__ import annotations

import numpy as np


def make_demo_tpwl(r: int = 21, P: int = 64, m: int = 4, nz: int = 6,
                   nf: int = 64, seed: int = 0, dtype=np.float32,
                   device="cuda"):
    """A stable synthetic TPWL dictionary at Diamond-like dimensions: each
    point a damped second-order system in modal form, with dynamics that
    vary smoothly across points. The numbers are drawn from numpy's
    generator in the JAX package's order, so both packages build the same
    model from the same seed."""
    from soft_robot_control_tpu_torch.models.tpwl import TPWLModel
    from soft_robot_control_tpu_torch.rom.pod import POD

    rng = np.random.default_rng(seed)
    n = 2 * r
    A_c = np.zeros((P, n, n), dtype=dtype)
    B_c = np.zeros((P, n, m), dtype=dtype)
    d_c = np.zeros((P, n), dtype=dtype)
    q_pts = np.zeros((P, r), dtype=dtype)
    v_pts = np.zeros((P, r), dtype=dtype)
    u_pts = rng.uniform(0, 1, size=(P, m)).astype(dtype)

    base_w = rng.uniform(2.0, 12.0, size=r)
    base_zeta = rng.uniform(0.2, 0.6, size=r)
    Bv = rng.normal(size=(r, m)).astype(dtype)

    for p in range(P):
        s = 1.0 + 0.2 * np.sin(2 * np.pi * p / P + np.arange(r))
        w = base_w * s
        # x = [v; q]: vdot = -2 zeta w v - w^2 q + B u; qdot = v
        A = np.zeros((n, n))
        A[:r, :r] = -np.diag(2 * base_zeta * w)
        A[:r, r:] = -np.diag(w**2)
        A[r:, :r] = np.eye(r)
        A_c[p] = A
        B_c[p, :r] = Bv * (1.0 + 0.1 * np.cos(2 * np.pi * p / P))
        q_pts[p] = 0.3 * rng.normal(size=r)
        v_pts[p] = 0.1 * rng.normal(size=r)
        d_c[p] = 0.01 * rng.normal(size=n)

    U, _ = np.linalg.qr(rng.normal(size=(nf, r)))
    rom = POD({"U": U.astype(dtype), "q_ref": rng.normal(size=nf).astype(dtype),
               "v_ref": np.zeros(nf, dtype=dtype)}, device=device)
    model = TPWLModel(q=q_pts, v=v_pts, u=u_pts, A_c=A_c, B_c=B_c, d_c=d_c,
                      rom=rom, dist_w_q=10.0, dist_w_v=1.0,
                      discr_method="zoh", tpwl_method="nn", device=device)
    Hf = rng.normal(size=(nz, 2 * nf)).astype(dtype) * 0.3
    Cf = rng.normal(size=(nz, 2 * nf)).astype(dtype) * 0.3
    return model.set_output_model(Hf).set_measurement_model(Cf)


def demo_targets(model, n_windows: int, N_replan: int, N: int, dt: float,
                 batch: int, amp: float = 0.1, seed: int = 0):
    """Batch of phase-shifted sinusoidal output targets around the model's
    z_ref, pre-windowed: (batch, n_windows, N+1, n_z) numpy."""
    from soft_robot_control_tpu_torch.control.batch_mpc import window_targets

    rng = np.random.default_rng(seed)
    nz = model.H.shape[0]
    z_ref = model.z_ref.cpu().numpy()
    dtype = model.q.cpu().numpy().dtype
    T = n_windows * N_replan + N + 1
    t = dt * np.arange(T)
    out = []
    for _ in range(batch):
        ph = rng.uniform(0, 2 * np.pi, size=nz)
        a = amp * rng.uniform(0.5, 1.0, size=nz)
        z = z_ref[None, :] + a[None, :] * np.sin(
            2 * np.pi * t[:, None] / 4.0 + ph[None, :])
        out.append(window_targets(z.astype(dtype), n_windows, N_replan, N))
    return np.stack(out)
