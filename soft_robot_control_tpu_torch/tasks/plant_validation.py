"""Validate the tet-FEM plant against SOFA-recorded ground truth (port of
the JAX package's tasks/plant_validation.py).

The reference validates its ROMs by driving them with a recorded input
sequence and comparing the predicted tip trajectory to the SOFA-recorded
one (examples/hardware/diamond.py:20-73, TPWL_rollout). The recorded data,
examples/hardware/checkModel/u_big.csv + z_big.csv (10 s at dt=0.01, tip
node 1354, z rows [v_tip; q_tip]), validates the PLANT itself
(sim/fem_tet.py): the Diamond tet FEM at the hardware calibration is
driven open-loop with u_big on its device and its tip trajectory scored
against z_big with the reference's MSE formula (diamond.py:69-72).

    python -m soft_robot_control_tpu_torch.tasks.plant_validation \
        [--device cuda|cpu] [--steps N] [--calibrate] [--out summary.json]
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from soft_robot_control_tpu_torch.sim.fem_tet import REFERENCE_ROOT

REFERENCE_CHECKMODEL = os.path.join(REFERENCE_ROOT, "examples", "hardware",
                                    "checkModel")


def load_check_data(path: str = REFERENCE_CHECKMODEL):
    """Recorded SOFA run: u (T, 4) cable forces, z (T, 6) = [v_tip; q_tip]
    absolute scene coordinates at node 1354, dt = 0.01."""
    u = np.genfromtxt(os.path.join(path, "u_big.csv"), delimiter=",")
    z = np.genfromtxt(os.path.join(path, "z_big.csv"), delimiter=",")
    return u, z


def diamond_plant_vs_sofa(plant=None, *, dtype=np.float32, n_steps=None,
                          chunk: int = 500, tip_node: int = 1354,
                          data_path: str = REFERENCE_CHECKMODEL,
                          device="cuda"):
    """Drive the Diamond tet plant (built on `device` in `dtype` when none
    is given) with the recorded u_big and score the tip trajectory against
    z_big.

    Returns a dict with the reference's MSE (diamond.py:69-72:
    ||err||_F^2 / T over [q_tip; v_tip]), the position-only RMSE in mm,
    a motion-normalized relative error, and the equilibrium offset.
    """
    from soft_robot_control_tpu_torch.sim.fem_surrogate import simulate_chunked
    from soft_robot_control_tpu_torch.utils.device import to_numpy

    u_true, z_true = load_check_data(data_path)
    if n_steps is not None:
        u_true = u_true[:n_steps + 1]
        z_true = z_true[:n_steps + 1]
    v_true, q_true = z_true[:, :3], z_true[:, 3:]

    if plant is None:
        from soft_robot_control_tpu_torch.sim.fem_tet import diamond_tet_fem
        plant = diamond_tet_fem(dtype=dtype, device=device)

    dt = plant.dt
    x0 = plant.x_rest()
    q_eq = to_numpy(plant.q_eq).reshape(-1, 3)
    eq_offset = q_eq[tip_node] - q_true[0]

    # u row t is the command over [t, t+dt) (closed_loop_controller.py:104
    # applies the command before the step); state row t+1 is its result
    X = to_numpy(simulate_chunked(plant, x0, u_true[:-1], dt, chunk=chunk))
    q_sim = X[:, X.shape[1] // 2:].reshape(X.shape[0], -1, 3)[:, tip_node]
    v_sim = X[:, :X.shape[1] // 2].reshape(X.shape[0], -1, 3)[:, tip_node]

    T = len(z_true)
    err_qv = np.hstack((q_sim[:T] - q_true[:T], v_sim[:T] - v_true[:T]))
    mse_ref = float(np.linalg.norm(err_qv) ** 2 / err_qv.shape[0])
    pos_err = np.linalg.norm(q_sim[:T] - q_true[:T], axis=1)
    rmse_mm = float(np.sqrt(np.mean(pos_err ** 2)))
    motion = np.linalg.norm(q_true - q_true[0], axis=1)
    rel = rmse_mm / max(float(motion.max()), 1e-9)
    return {
        "mse_ref_formula": mse_ref,
        "tip_rmse_mm": rmse_mm,
        "tip_max_err_mm": float(pos_err.max()),
        "rel_err_vs_motion": rel,
        "motion_range_mm": float(motion.max()),
        "eq_offset_mm": [float(a) for a in eq_offset],
        "eq_offset_norm_mm": float(np.linalg.norm(eq_offset)),
        "n_steps": int(T),
        "dt": float(dt),
        "q_sim": q_sim[:T],
        "q_true": q_true[:T],
    }


REFERENCE_REST_QV = os.path.join(REFERENCE_ROOT, "examples", "hardware",
                                 "rest_qv.pkl")


def load_sofa_rest(path: str = REFERENCE_REST_QV):
    """SOFA's recorded Diamond equilibrium (q, v) (rest_qv.pkl, saved by
    open_loop_controller.py:111-115)."""
    with open(path, "rb") as f:
        rest = pickle.load(f)
    q, v = rest["rest"]
    return np.asarray(q), np.asarray(v)


def calibrate_diamond_young(plant=None, *, dtype=np.float32,
                            settle_time: float = 2.5, iters: int = 4,
                            rest_path: str = REFERENCE_REST_QV,
                            device="cuda"):
    """Fit a single Young's-modulus scale so the plant's gravity sag matches
    SOFA's recorded equilibrium field (the 'model calibration' role of
    examples/hardware/calibration.py:90-178, done against the shipped
    rest_qv.pkl instead of new SOFA runs).

    The sag is ~linear in 1/E, so a secant iteration on
    mean-sag(s) = mean-sag_SOFA converges in 2-3 steps. Returns
    (calibrated plant, info dict).
    """
    from soft_robot_control_tpu_torch.sim.fem_tet import with_young_scale
    from soft_robot_control_tpu_torch.utils.device import to_numpy

    if plant is None:
        from soft_robot_control_tpu_torch.sim.fem_tet import diamond_tet_fem
        plant = diamond_tet_fem(dtype=dtype, device=device)
    q_ref, _ = load_sofa_rest(rest_path)
    q_ref3 = q_ref.reshape(-1, 3)
    rest3 = to_numpy(plant.rest_pos).reshape(-1, 3)
    sag_ref = float(np.linalg.norm(q_ref3 - rest3, axis=1).mean())

    def eval_scale(s):
        p = with_young_scale(plant, s, settle_time=settle_time)
        q3 = to_numpy(p.q_eq).reshape(-1, 3)
        sag = float(np.linalg.norm(q3 - rest3, axis=1).mean())
        err = float(np.linalg.norm(q3 - q_ref3, axis=1).mean())
        return p, sag, err

    history = []
    s0, s1 = 1.0, None
    p, sag0, err0 = eval_scale(s0)
    history.append({"scale": s0, "mean_sag_mm": sag0, "mean_err_mm": err0})
    # sag(s) ~ sag(1)/s  =>  first secant guess
    s1 = s0 * sag0 / sag_ref
    for _ in range(iters - 1):
        p, sag1, err1 = eval_scale(s1)
        history.append({"scale": s1, "mean_sag_mm": sag1,
                        "mean_err_mm": err1})
        if abs(sag1 - sag_ref) < 1e-3 * sag_ref:
            break
        # secant on f(s) = sag(s) - sag_ref
        f0, f1 = sag0 - sag_ref, sag1 - sag_ref
        if f1 == f0:
            break
        s2 = s1 - f1 * (s1 - s0) / (f1 - f0)
        s0, sag0, s1 = s1, sag1, float(np.clip(s2, 0.25, 4.0))
    best = min(history, key=lambda h: h["mean_err_mm"])
    p = with_young_scale(plant, best["scale"], settle_time=settle_time)
    info = {"scale": best["scale"], "sofa_mean_sag_mm": sag_ref,
            "history": history,
            "eq_field_err_mm_mean": best["mean_err_mm"]}
    return p, info


def main(argv=None):
    """The validation from the command line: f32 on the card, f64 on the
    CPU (--device cpu); the summary JSON printed and, with --out,
    written."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the Young's-modulus scale to rest_qv.pkl "
                         "before the dynamic validation")
    ap.add_argument("--out", default=None,
                    help="write the summary JSON here")
    args = ap.parse_args(argv)
    dtype = np.float64 if args.device == "cpu" else np.float32
    plant = None
    cal_info = None
    if args.calibrate:
        plant, cal_info = calibrate_diamond_young(dtype=dtype,
                                                  device=args.device)
        print("calibration:", json.dumps(cal_info, indent=1))
    res = diamond_plant_vs_sofa(plant=plant, dtype=dtype,
                                n_steps=args.steps, device=args.device)
    summary = {k: v for k, v in res.items()
               if not isinstance(v, np.ndarray)}
    if cal_info is not None:
        summary["calibration"] = cal_info
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
