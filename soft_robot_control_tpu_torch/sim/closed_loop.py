"""Closed-loop simulation harness (sofacontrol/closed_loop_controller.py
and launch_sofa.py:66-90): step the plant, form the (optionally noisy)
measurement, call `controller.evaluate(t, y, x, u_prev)`, apply the
command, and log {t, u, z, z_hat, q, x} until `sim_duration`, returning
the sim_data dict layout the reference pickles.

The plant is any object with `x_rest()`, `input_dim` and `step(x, u, dt)`
on tensors (the FEM surrogate of sim/fem_surrogate.py); the plant state
stays a tensor on the plant's device, and the controller receives the
measurement and the state as tensors. The logs are numpy arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.utils.device import as_tensor, to_numpy


def run_closed_loop(plant, controller, sim_duration, dt, x0=None,
                    measurement_model=None, output_model=None,
                    generator: Optional[torch.Generator] = None,
                    save_full_state=False, u_limits=None):
    """Run the closed loop and return the sim_data dict
    (closed_loop_controller.py:50-58,118-137 layout).

    A measurement model's noise is drawn from `generator` when one is
    given (the JAX package takes a PRNG key there). u_limits=(u_min,
    u_max) clamps the applied command to the actuation limits, as the
    reference bridge clamps actuator values (closed_loop_controller.py:
    104-117): it bounds the LQR feedback term u_bar + K (x_hat - x_bar)
    that the plan's QP constraints cannot see."""
    if x0 is None:
        x0 = plant.x_rest()
    x = as_tensor(x0, plant.dtype, plant.device)
    controller.set_sim_timestep(dt)

    n_steps = int(round(sim_duration / dt))
    m = plant.input_dim
    u_prev = np.zeros(m)

    data = {"t": [], "u": [], "z": [], "z_hat": [], "q": [], "x": []}
    for i in range(n_steps):
        t = i * dt
        if measurement_model is not None:
            if generator is not None:
                y = measurement_model.evaluate(x, generator=generator)
            else:
                y = measurement_model.evaluate(x)
        else:
            y = x
        u = controller.evaluate(t, y, x, u_prev)
        if u_limits is not None:
            u = np.clip(np.asarray(u), u_limits[0], u_limits[1])
        x = plant.step(x, as_tensor(np.asarray(u), x.dtype, x.device), dt)
        u_prev = np.asarray(u)

        data["t"].append(t)
        data["u"].append(np.asarray(u))
        if output_model is not None:
            data["z"].append(to_numpy(output_model.evaluate(x)))
        if getattr(controller, "observer", None) is not None and \
                getattr(controller.observer, "z", None) is not None:
            data["z_hat"].append(to_numpy(controller.observer.z))
        if save_full_state:
            data["x"].append(to_numpy(x))

    sim_data = {k: np.asarray(v) for k, v in data.items() if len(v)}
    sim_data["dt"] = dt
    if hasattr(controller, "save_controller_info"):
        sim_data["info"] = controller.save_controller_info()
    return sim_data
