"""Synthetic tracking targets for demos and benchmarks."""

from __future__ import annotations

import numpy as np


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
