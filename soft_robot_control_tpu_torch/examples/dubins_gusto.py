"""GuSTO on the analytic Dubins car, the solver check that needs no robot:
the twin of examples/dubins_gusto.py on the port.

    python -m soft_robot_control_tpu_torch.examples.dubins_gusto [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from soft_robot_control_tpu_torch.utils.device import to_numpy


def solve(device="cuda", dtype=torch.float64, verbose=1):
    """The script's problem: N=50 steps of 0.1 s from rest to (4, 5, 0),
    input rates within 0.1, a terminal cost only. Returns GuSTO's
    (x, u, z, LOCP seconds) as numpy, and its SCP iterations."""
    from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
    from soft_robot_control_tpu_torch.models.dubins import DubinsCar
    from soft_robot_control_tpu_torch.scp.gusto import GuSTO

    model = DubinsCar(dtype=dtype, device=device)
    N, dt = 50, 0.1
    Qz = np.zeros((3, 3))
    R = np.eye(2)
    Qzf = 100 * np.eye(3)
    zf_des = np.array([4.0, 5.0, 0.0])
    x0 = np.zeros(3)
    u_init = np.zeros((N, 2))
    x_init = to_numpy(model.rollout(x0, u_init, dt))
    dU = HyperRectangle(np.array([0.1, 0.1]), np.array([-0.1, -0.1]))
    gusto = GuSTO(model, N, dt, Qz, R, x0, u_init, x_init, u=u_init,
                  zf=zf_des, Qzf=Qzf, dU=dU, verbose=verbose,
                  warm_start=True, x_char=np.array([1.0, 1.0, np.pi]))
    x, u, z, t_solve = gusto.get_solution()
    return (to_numpy(x), to_numpy(u), to_numpy(z), float(t_solve),
            gusto.itr_count)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    x, u, _, t_solve, iters = solve(args.device)
    print(f"terminal state: {np.round(x[-1], 3)} (target [4. 5. 0.])")
    print(f"max |du|: {np.abs(np.diff(u, axis=0)).max():.3f} (limit 0.1)")
    print(f"LOCP time: {t_solve:.3f} s over {iters} SCP iterations")


if __name__ == "__main__":
    main()
