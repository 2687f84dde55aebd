"""The plain reference against the program's own plain path on the CPU,
both in float64, on a dictionary cut to a few points (in this test only:
every cell runs the dictionaries as committed). The two must agree to
rounding, or the reference does not compute what the program does."""

import os
import pickle

import numpy as np
import pytest
import torch

from port_bench.harness import registry
from port_bench.reference.mpc import ClosedLoop, dare_gains
from port_bench.reference.numerics import Numerics
from port_bench.reference.tpwl import load_dictionary, rollout

POINTS = 24
KEYS = ("q", "v", "u", "A_c", "B_c", "d_c", "A_d", "B_d", "d_d")


def cut(config_name, tmp_path):
    """The configuration in float64 on a dictionary of POINTS of its
    points, written to tmp_path."""
    cfg = registry.config(config_name)
    with open(os.path.join(registry.ROOT, cfg["dictionary"]), "rb") as f:
        raw = pickle.load(f)
    keep = np.linspace(0, len(raw["q"]) - 1, POINTS).astype(int)
    small = {k: np.asarray(raw[k])[keep] for k in KEYS}
    small.update(rom_info=raw["rom_info"], dt=raw["dt"])
    path = tmp_path / f"{config_name}.pkl"
    with open(path, "wb") as f:
        pickle.dump(small, f)
    return dict(cfg, dictionary=str(path), dtype="float64", points=POINTS)


def driver(cfg, traffic_name, **over):
    traffic = dict(registry.traffic(traffic_name), **over)
    drv = registry.entry(traffic["kind"]).Driver(cfg, traffic, 1234567,
                                                 "cpu")
    drv.setup()
    return drv


@pytest.mark.parametrize("config_name", ["diamond_tpwl", "trunk_tpwl"])
def test_closed_loop_matches_the_program(config_name, tmp_path):
    cfg = cut(config_name, tmp_path)
    drv = driver(cfg, "mpc_fleet_b4096", batch=6, pool=1)
    z, u = drv.call(0)
    ref = ClosedLoop(drv.ref, Numerics(torch.float64), drv.s)
    zt, noise = drv.pool[0]
    zr, ur = ref.run(drv.x0, drv.x0, zt, noise)
    motion = float((zr - drv.ref.z_ref).abs().max())
    assert motion > 1e-3
    assert float((z - zr).abs().max()) <= 1e-9 * motion
    assert float((u - ur).abs().max()) <= 1e-9 * cfg["u_ub"]


@pytest.mark.parametrize("config_name", ["diamond_tpwl", "trunk_tpwl"])
def test_dare_gains_match_the_program(config_name, tmp_path):
    from soft_robot_control_tpu_torch.lqr.riccati import dare

    cfg = cut(config_name, tmp_path)
    drv = driver(cfg, "mpc_fleet_b4096", batch=2, pool=1)
    dic = drv.ref
    K = dare_gains(dic, Numerics(torch.float64), drv.s)
    nu = dic.n_u
    Kp, _ = dare(dic.A, dic.B, drv.s.Qz * dic.H.T @ dic.H,
                 drv.s.R * torch.eye(nu, dtype=torch.float64))
    assert float((K - Kp).abs().max()) <= 1e-9 * float(Kp.abs().max())


def test_rollouts_match_the_program(tmp_path):
    cfg = cut("diamond_tpwl", tmp_path)
    drv = driver(cfg, "rollouts_b32768_t100", batch=8, steps=12, pool=1)
    X = drv.call(0)
    x0, u = drv.pool[0]
    Xr = rollout(drv.reference(), Numerics(torch.float64), x0, u)
    assert float((X - Xr).abs().max()) <= 1e-12 * float(Xr.abs().max())


def test_output_maps_are_the_programs(tmp_path):
    from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
    from soft_robot_control_tpu_torch.sim.measurement import linearModel

    cfg = cut("trunk_tpwl", tmp_path)
    dic = load_dictionary(cfg, registry.ROOT, "cpu", Numerics())
    Cf = linearModel(cfg["measurement_nodes"], cfg["num_nodes"]).C_dense()
    Hf = linearModel(cfg["output_nodes"], cfg["num_nodes"],
                     vel=False).C_dense()
    m = from_tpwl_dict(cfg["dictionary"], Cf=Cf, Hf=Hf, device="cpu")
    for a, b in ((dic.C, m.C), (dic.y_ref, m.y_ref), (dic.H, m.H),
                 (dic.z_ref, m.z_ref)):
        assert torch.equal(a, b.to(torch.float64))


def test_batched_gusto_matches_the_program(tmp_path):
    from port_bench.reference.gusto import BatchGuSTO

    cfg = cut("diamond_tpwl", tmp_path)
    drv = driver(cfg, "gusto_b256", batch=4, pool=1)
    x, u, it, cv, J = drv.call(0)
    xr, ur, itr, cvr, Jr = BatchGuSTO(drv.reference(),
                                      Numerics(torch.float64),
                                      drv.s).run(*drv.pool[0])
    assert torch.equal(it.long(), itr) and torch.equal(cv, cvr)
    assert float((x - xr).abs().max()) <= 1e-8 * float(xr.abs().max())
    assert float((u - ur).abs().max()) <= 1e-8 * cfg["u_ub"]
    assert float((J - Jr).abs().max()) <= 1e-8 * float(Jr.abs().max())
