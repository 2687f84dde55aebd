"""Batched trajectory optimization: GuSTO in lockstep.

Each call is `GuSTOJit(TPWLGuSTO(model), ...).solve_batch_fused` at the
traffic's batch, with the configuration's `gusto` settings: B problems,
each from a state near a dictionary point drawn at random (the point's
[v; q] plus x0_std N(0, I)), a zero initial command and the constant
trajectory at x0, toward the rest output z_ref (bench.py's section 4 takes
x0 = 0.05 N(0, I), where every problem has nearly the same answer).
The inputs of `pool` calls are drawn from the seed before the window
opens; call i takes pool entry i mod pool.

The check runs the plain reference in float64 on the kept calls' inputs.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from port_bench.harness.registry import ROOT, check_program_sizes
from port_bench.reference.gusto import BatchGuSTO, GuSTOSettings
from port_bench.reference.numerics import Numerics, control_numerics
from port_bench.reference.tpwl import (check_config, check_settings,
                                       load_dictionary, output_map,
                                       read_raw)

# the `gusto` settings the reference implements, with the values it takes
SUPPORTED = {"N": None, "Qz": None, "R": None, "max_iters": None,
             "qp_iters": None, "x_step": ("kinv",),
             "formulation": ("sparse",)}


def settings(cfg: dict) -> GuSTOSettings:
    """The reference's settings of the configuration's `gusto` group (dt
    is the `mpc` group's); raises where the group asks for what the
    reference does not implement (a formulation or x-step other than the
    sparse LOCP with K^-1)."""
    check_config(cfg)
    g = check_settings(f"{cfg['name']}.gusto", cfg["gusto"], SUPPORTED)
    return GuSTOSettings(N=g["N"], dt=cfg["mpc"]["dt"], Qz=g["Qz"], R=g["R"],
                         u_lb=cfg["u_lb"], u_ub=cfg["u_ub"],
                         max_iters=g["max_iters"], qp_iters=g["qp_iters"])


class Driver:
    throughput = ("solves_per_s", "solves/s")

    def __init__(self, cfg, traffic, seed, device, program="port"):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.program = program
        self.dtype = getattr(torch, cfg["dtype"])
        self.s = settings(cfg)
        self.B = int(traffic["batch"])
        self.work_per_call = self.B
        self.steps_per_call = self.s.max_iters

    def setup(self):
        self.make_inputs(self.seed)
        self.build()

    def raw(self):
        """The dictionary pickle, read once."""
        if getattr(self, "_raw", None) is None:
            self._raw = read_raw(self.cfg, ROOT)
        return self._raw

    def reference(self):
        """The plain reference's dictionary in float64, built after the
        window from the pickle that set-up read for the inputs."""
        if getattr(self, "ref", None) is None:
            self.ref = load_dictionary(self.cfg, ROOT, self.device,
                                       Numerics(torch.float64), self.raw())
        return self.ref

    def make_inputs(self, seed):
        """The pool of call inputs drawn from `seed`. The starting states
        lie near the dictionary's points, so this reads the dictionary's
        pickle (its points alone go to the device): input making, in
        set-up."""
        dev, s, cfg, raw = self.device, self.s, self.cfg, self.raw()
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        n, m, B = cfg["state_dim"], cfg["cables"], self.B
        info = raw["rom_info"]
        _, z_ref = output_map(np.asarray(info["U"]), np.asarray(info["q_ref"]),
                              np.asarray(info["v_ref"]), cfg["output_nodes"],
                              vel=False)
        z = torch.as_tensor(z_ref, dtype=self.dtype, device=dev).expand(
            B, s.N + 1, -1)
        u0 = torch.zeros((B, s.N, m), dtype=self.dtype, device=dev)
        self.pool = []
        pts = torch.as_tensor(np.concatenate([raw["v"], raw["q"]], axis=1),
                              dtype=torch.float64, device=dev)
        for _ in range(int(self.traffic["pool"])):
            i = torch.randint(cfg["points"], (B,), generator=gen,
                              device=dev)
            x0 = (pts[i] + self.traffic["x0_std"] * torch.randn(
                (B, n), generator=gen, dtype=torch.float64,
                device=dev)).to(self.dtype)
            self.pool.append((x0, u0, x0[:, None].expand(-1, s.N + 1, -1),
                              z))

    def build(self):
        """The timed path: the program, or the control in its place."""
        if self.program == "port":
            self.run = self._port()
        else:
            num = control_numerics(self.dtype)
            ctl = BatchGuSTO(load_dictionary(self.cfg, ROOT, self.device,
                                             num), num, self.s)
            self.run = ctl.run

    def _port(self):
        from soft_robot_control_tpu_torch.core.constraints import (
            HyperRectangle)
        from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
        from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
        from soft_robot_control_tpu_torch.scp.gusto_jit import GuSTOJit
        from soft_robot_control_tpu_torch.sim.measurement import linearModel

        cfg, g, s = self.cfg, self.cfg["gusto"], self.s
        Hf = linearModel(cfg["output_nodes"], cfg["num_nodes"],
                         vel=False).C_dense()
        model = from_tpwl_dict(
            os.path.join(ROOT, cfg["dictionary"]),
            params={"dist_weights": cfg["dist_weights"]}, Hf=Hf,
            device=self.device).to(dtype=self.dtype).pre_discretize(s.dt)
        check_program_sizes(model, cfg)
        nz, nu = Hf.shape[0], model.input_dim
        gj = GuSTOJit(
            TPWLGuSTO(model), N=s.N, dt=s.dt, Qz=s.Qz * np.eye(nz),
            R=s.R * np.eye(nu),
            U=HyperRectangle(s.u_ub * np.ones(nu), s.u_lb * np.ones(nu)),
            max_iters=s.max_iters, qp_iters=s.qp_iters, x_step=g["x_step"],
            formulation=g["formulation"], dtype=self.dtype)
        return lambda x0, u0, xi, z: tuple(gj.solve_batch_fused(
            x0, u0, xi, z))

    def call(self, i):
        return self.run(*self.pool[i % len(self.pool)])

    @staticmethod
    def finite(out):
        return torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all()

    def launches(self):
        """A lockstep iteration's hand kernels: the ADMM over the B sparse
        LOCPs (streaming form), the select of the discrete rows at the N
        trajectory states and of the continuous rows at the new and the
        old trajectory's."""
        s, B, c = self.s, self.B, self.cfg
        r, n, m, P = c["rom_dim"], c["state_dim"], c["cables"], c["points"]
        nv = (s.N + 1) * n + s.N * m + s.N + 1
        nc = (s.N + 1) * n + 2 * n * (s.N + 1) + (s.N + 1) + 2 * s.N * m
        per = [("admm_stream", (B, nv, nc, s.qp_iters, 4)),
               ("tpwl_select", (B * s.N, B * s.N, P, r, n, m, 4)),
               ("tpwl_select", (2 * B * s.N, 2 * B * s.N, P, r, n, m, 4))]
        return per * s.max_iters

    def release(self):
        self.run = None

    def check(self, kept):
        """The numbers over the kept calls, the largest of each, from a
        problem's largest |dx| over the call's largest |x_ref| and its
        largest |du| over the cable range: x_p50 and x_p75, the median and
        the 75th percentile over the problems of the x errors, and u_p50,
        the median of the u errors. A single problem is not held: the
        float32 sparse LOCP (a 1e3 rho on its equality rows) parts from
        float64 by up to most of the cable range in a few problems of a
        batch, as far as the control does (PERF.md)."""
        if getattr(self, "_ref_run", None) is None:
            self._ref_run = BatchGuSTO(self.reference(),
                                       Numerics(torch.float64),
                                       self.s).run
        out = {}
        for i, (x, u, *_) in kept:
            xr, ur, *_ = self._ref_run(*self.pool[i % len(self.pool)])
            ex = ((x.double() - xr).abs().amax(dim=(1, 2))
                  / xr.abs().max())
            eu = ((u.double() - ur).abs().amax(dim=(1, 2))
                  / (self.s.u_ub - self.s.u_lb))
            vals = {"x_p50": float(torch.quantile(ex, 0.5)),
                    "x_p75": float(torch.quantile(ex, 0.75)),
                    "u_p50": float(torch.quantile(eu, 0.5))}
            for k, v in vals.items():
                v = v if math.isfinite(v) else math.inf
                out[k] = max(out.get(k, v), v)
        return out
