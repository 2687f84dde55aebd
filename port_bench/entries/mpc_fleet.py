"""A fleet of batched closed-loop MPC + EKF controllers.

Each call is `BatchMPC.build_fused(windows)` of the configuration at the
traffic's batch: every loop starts from rest with its estimate at rest and
tracks a feasible target (the dictionary's own output under smooth
admissible cable inputs of random phases), with standard normal
measurement noise scaled by `noise_std`. The inputs of `pool` calls are
drawn from the seed before the window opens; call i takes pool entry
i mod pool.

The check runs the plain reference in float64 on the kept calls' inputs
and compares the outputs z and commands u of every tick of every loop.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from port_bench.harness.registry import ROOT, check_program_sizes
from port_bench.reference.mpc import ClosedLoop, MPCSettings
from port_bench.reference.numerics import Numerics, control_numerics
from port_bench.reference.tpwl import (check_config, check_settings,
                                       load_dictionary, rollout)

# the `mpc` settings the reference implements, with the values it takes
SUPPORTED = {"N": None, "N_replan": None, "dt": None, "Qz": None, "R": None,
             "qp_iters": None, "rho_stages": None, "rho": None,
             "scaling_iters": None, "W": None, "V": None,
             "x_step": ("kinv",), "formulation": ("condensed",)}


def settings(cfg: dict, traffic: dict) -> MPCSettings:
    """The reference's settings of the configuration's `mpc` group; raises
    where the group asks for what the reference does not implement (a
    formulation or x-step other than the condensed QP with K^-1)."""
    check_config(cfg)
    c = check_settings(f"{cfg['name']}.mpc", cfg["mpc"], SUPPORTED)
    return MPCSettings(N=c["N"], N_replan=c["N_replan"], Qz=c["Qz"],
                       R=c["R"], u_lb=cfg["u_lb"], u_ub=cfg["u_ub"],
                       qp_iters=c["qp_iters"], rho_stages=c["rho_stages"],
                       rho=c["rho"], scaling_iters=c["scaling_iters"],
                       W=c["W"], V=c["V"], noise_std=traffic["noise_std"])


def feasible_targets(dic, s: MPCSettings, windows: int, B: int, period: float,
                     gen):
    """(B, windows, N+1, n_z) window targets: the dictionary's output from
    rest under u = (lb + ub) / 2 + (ub - lb) / 2 sin(2 pi t / period + phi),
    phi uniform per loop and cable, window w starting at tick w N_replan
    (clipped at the trajectory's end)."""
    T = windows * s.N_replan + s.N + 1
    dev, dt = dic.A.device, dic.A.dtype
    t = dic.dt * torch.arange(T - 1, dtype=dt, device=dev)
    phi = 2 * math.pi * torch.rand((B, 1, dic.n_u), generator=gen,
                                   dtype=dt, device=dev)
    mid, half = 0.5 * (s.u_lb + s.u_ub), 0.5 * (s.u_ub - s.u_lb)
    u = mid + half * torch.sin(2 * math.pi * t[None, :, None] / period + phi)
    X = rollout(dic, Numerics(dt), torch.zeros((B, dic.n_x), dtype=dt,
                                               device=dev), u)
    z = X @ dic.H.T + dic.z_ref                       # (B, T, n_z)
    idx = (torch.arange(windows, device=dev)[:, None] * s.N_replan
           + torch.arange(s.N + 1, device=dev)[None])
    return z[:, torch.clamp(idx, max=T - 1)]


class Driver:
    throughput = ("windows_per_s", "windows/s")

    def __init__(self, cfg, traffic, seed, device, program="port"):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.program = program
        self.dtype = getattr(torch, cfg["dtype"])
        self.s = settings(cfg, traffic)
        self.B, self.windows = int(traffic["batch"]), int(traffic["windows"])
        self.work_per_call = self.B * self.windows
        self.steps_per_call = self.windows

    # -- set-up --------------------------------------------------------------
    def setup(self):
        self.make_inputs(self.seed)
        self.build()

    def reference(self):
        """The plain reference's dictionary in float64, read once: the
        inputs' targets are its own outputs, and the check runs on it."""
        if getattr(self, "ref", None) is None:
            self.ref = load_dictionary(self.cfg, ROOT, self.device,
                                       Numerics(torch.float64),
                                       continuous=False)
        return self.ref

    def make_inputs(self, seed):
        """The pool of call inputs drawn from `seed`. The targets are the
        dictionary's own outputs, so this reads the dictionary: input
        making, in set-up."""
        dev, s, ref = self.device, self.s, self.reference()
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        ny = ref.C.shape[0]
        self.pool = []
        for _ in range(int(self.traffic["pool"])):
            zt = feasible_targets(ref, s, self.windows, self.B,
                                  self.traffic["target_period_s"], gen)
            noise = torch.randn((self.windows, s.N_replan, self.B, ny),
                                generator=gen, dtype=self.dtype,
                                device=dev)
            self.pool.append((zt.to(self.dtype), noise))
        self.x0 = torch.zeros((self.B, ref.n_x), dtype=self.dtype,
                              device=dev)

    def build(self):
        """The timed path: the program, or the control in its place."""
        if self.program == "port":
            self.run = self._port()
        else:
            num = control_numerics(self.dtype)
            ctl = ClosedLoop(load_dictionary(self.cfg, ROOT, self.device,
                                             num), num, self.s)
            self.run = lambda x0, xe, zt, noise: dict(zip(
                ("z", "u"), ctl.run(x0, xe, zt, noise)))

    def _port(self):
        from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
        from soft_robot_control_tpu_torch.core.constraints import (
            HyperRectangle)
        from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
        from soft_robot_control_tpu_torch.sim.measurement import linearModel

        cfg, c, s = self.cfg, self.cfg["mpc"], self.s
        Cf = linearModel(cfg["measurement_nodes"], cfg["num_nodes"]).C_dense()
        Hf = linearModel(cfg["output_nodes"], cfg["num_nodes"],
                         vel=False).C_dense()
        model = from_tpwl_dict(
            os.path.join(ROOT, cfg["dictionary"]),
            params={"dist_weights": cfg["dist_weights"]}, Cf=Cf, Hf=Hf,
            device=self.device)
        check_program_sizes(model, cfg)
        nx, nu, nz, ny = (model.state_dim, model.input_dim, Hf.shape[0],
                          Cf.shape[0])
        mpc = BatchMPC(
            model, s.Qz * np.eye(nz), s.R * np.eye(nu), N=s.N, dt=c["dt"],
            N_replan=s.N_replan,
            U=HyperRectangle(s.u_ub * np.ones(nu), s.u_lb * np.ones(nu)),
            rho=s.rho, qp_iters=s.qp_iters, scp_iters=1,
            W=s.W * np.eye(nx), V=s.V * np.eye(ny), x_step=c["x_step"],
            formulation=c["formulation"], scaling_iters=s.scaling_iters,
            rho_stages=s.rho_stages, dtype=self.dtype,
            device=self.device)
        return mpc.build_fused(self.windows, noise_std=s.noise_std)

    # -- the timed path -------------------------------------------------------
    def call(self, i):
        zt, noise = self.pool[i % len(self.pool)]
        out = self.run(self.x0, self.x0, zt, noise)
        return out["z"], out["u"]

    @staticmethod
    def finite(out):
        return torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all()

    def launches(self):
        """The hand kernels' launches of one call, from the shapes: a rho
        stage's ADMM over the condensed QPs (N n_u variables, a lower and
        an upper row each), one select at the plan states a window and one
        a tick at the plan point, the plant and the estimate (rows for the
        last two)."""
        s, B, c = self.s, self.B, self.cfg
        r, n, m, P = c["rom_dim"], c["state_dim"], c["cables"], c["points"]
        nv = s.N * m
        out = []
        for _ in range(self.windows):
            out.append(("tpwl_select", (B * s.N, B * s.N, P, r, n, m, 4)))
            out += [("admm_batched", (B, nv, 2 * nv,
                                      s.qp_iters // s.rho_stages, 4))
                    ] * s.rho_stages
            out += [("tpwl_select", (3 * B, 2 * B, P, r, n, m, 4))
                    ] * s.N_replan
        return out

    def release(self):
        self.run = None

    # -- the check -----------------------------------------------------------
    def check(self, kept):
        """The numbers over the kept calls, the largest of each. A loop's
        error is its largest |dz| over its ticks, in units of the call's
        largest output motion |z_ref - z_rest|, and its largest |du| in
        units of the cable range:
        - z_p50, z_p75: the median and the 75th percentile of the loops'
          z errors;
        - u_p50: the median of the loops' u errors;
        - z_first_worst: the largest z error of any loop at its first tick,
          the plant's step under the first QP's command from rest, in
          units of the largest output motion at that tick.
        Past that tick a loop's error is not a number to hold one by one: a
        float32 rounding moves a state across the boundary between two
        nearest points in some loops, and from there the loop follows
        another linearization (PERF.md)."""
        ref = self.reference()
        if getattr(self, "_ref_loop", None) is None:
            self._ref_loop = ClosedLoop(ref, Numerics(torch.float64), self.s)
        s = self.s
        out = {}
        for i, (z, u) in kept:
            zt, noise = self.pool[i % len(self.pool)]
            x0 = self.x0.double()
            zr, ur = self._ref_loop.run(x0, x0, zt.double(), noise.double())
            motion = (zr - ref.z_ref).abs()
            ez = (z.double() - zr).abs().amax(dim=2) / motion.max()  # (B, T)
            eu = ((u.double() - ur).abs().amax(dim=(1, 2))
                  / (s.u_ub - s.u_lb))
            loop = ez.amax(dim=1)
            first = ((z[:, 0].double() - zr[:, 0]).abs().max()
                     / motion[:, 0].max())
            vals = {"z_p50": float(torch.quantile(loop, 0.5)),
                    "z_p75": float(torch.quantile(loop, 0.75)),
                    "u_p50": float(torch.quantile(eu, 0.5)),
                    "z_first_worst": float(first)}
            for k, v in vals.items():
                v = v if math.isfinite(v) else math.inf
                out[k] = max(out.get(k, v), v)
        return out
