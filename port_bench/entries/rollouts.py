"""Batched open-loop rollouts of the nearest-point dynamics.

Each call is `rollout_batch(model, x0, u, dt, select="exact")` on the
configuration's dictionary, pre-discretized at its own dt: B rollouts of T
steps from x0 = x0_std N(0, I), under cable commands u = u_scale |N(0, 1)|
clipped into the cable box, drawn independently for every step. The inputs
of `pool` calls are drawn from the seed before the window opens; call i
takes pool entry i mod pool.

The check rolls the same inputs through the plain reference in float64
and compares every state of every rollout.
"""

from __future__ import annotations

import math
import os

import torch

from port_bench.harness.registry import ROOT, check_program_sizes
from port_bench.reference.numerics import Numerics, control_numerics
from port_bench.reference.tpwl import (check_config, load_dictionary,
                                       next_states, rollout)


CHUNK = 16384    # states a block of the check
TIE = 1e-5       # relative distance gap under which two points tie in float32


class Driver:
    throughput = ("rollout_steps_per_s", "steps/s")

    def __init__(self, cfg, traffic, seed, device, program="port"):
        check_config(cfg)
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.program = program
        self.dtype = getattr(torch, cfg["dtype"])
        self.B, self.T = int(traffic["batch"]), int(traffic["steps"])
        self.work_per_call = self.B * self.T
        self.steps_per_call = self.T

    def setup(self):
        self.make_inputs(self.seed)
        self.build()

    def make_inputs(self, seed):
        """The pool of call inputs drawn from `seed`."""
        dev, cfg, tr = self.device, self.cfg, self.traffic
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        n, m = cfg["state_dim"], cfg["cables"]
        self.pool = []
        for _ in range(int(tr["pool"])):
            x0 = tr["x0_std"] * torch.randn((self.B, n), generator=gen,
                                            dtype=self.dtype, device=dev)
            u = torch.clamp(tr["u_scale"] * torch.randn(
                (self.B, self.T, m), generator=gen, dtype=self.dtype,
                device=dev).abs(), cfg["u_lb"], cfg["u_ub"])
            self.pool.append((x0, u))

    def build(self):
        """The timed path: the program, or the control in its place."""
        dev, cfg = self.device, self.cfg
        if self.program == "port":
            from soft_robot_control_tpu_torch.models.tpwl import (
                from_tpwl_dict, rollout_batch)

            model = from_tpwl_dict(
                os.path.join(ROOT, cfg["dictionary"]),
                params={"dist_weights": cfg["dist_weights"]},
                device=dev).to(dtype=self.dtype)
            check_program_sizes(model, cfg)
            dt = cfg["mpc"]["dt"]
            self.run = lambda x0, u: rollout_batch(model, x0, u, dt,
                                                   select="exact")
        else:
            num = control_numerics(self.dtype)
            dic = load_dictionary(cfg, ROOT, dev, num)
            self.run = lambda x0, u: rollout(dic, num, x0, u)

    def call(self, i):
        x0, u = self.pool[i % len(self.pool)]
        return self.run(x0, u)

    @staticmethod
    def finite(out):
        return torch.isfinite(out).all()

    def launches(self):
        """One select a step for all B states, rows for each."""
        c = self.cfg
        shape = (self.B, self.B, c["points"], c["rom_dim"], c["state_dim"],
                 c["cables"], 4)
        return [("tpwl_select", shape)] * self.T

    def reference(self):
        """The plain reference's dictionary in float64, read once."""
        if getattr(self, "ref", None) is None:
            self.ref = load_dictionary(self.cfg, ROOT, self.device,
                                       Numerics(torch.float64),
                                       continuous=False)
        return self.ref

    def release(self):
        self.run = None

    def check(self, kept):
        """The numbers over the kept calls, the largest of each. The first
        state of every rollout must be its x0 (x0_gap, exact). Every later
        state is judged from the program's own state before it: the
        reference takes the step from that state at its nearest point, or
        at any point whose distance is within TIE of the nearest's
        (a float32 distance may order such points either way), and the
        step that lies closest to the program's state is the one held.
        - step_worst: the largest |dx| of any state over the largest state;
        - step_rel: |dX| / |X| over all steps of all rollouts.
        A rollout as a whole is not held to a free-running reference: at
        a near tie one float32 rounding sends it along another point's
        dynamics, and from there it parts from the reference for good."""
        num, ref = Numerics(torch.float64), self.reference()
        n, m = ref.n_x, ref.n_u
        out = {}
        for i, X in kept:
            x0, u = self.pool[i % len(self.pool)]
            X = X.double()
            vals = {"x0_gap": float((X[:, 0] - x0.double()).abs().max())}
            xs = X[:, :-1].reshape(-1, n)
            us = u.double().reshape(-1, m)
            got = X[:, 1:].reshape(-1, n)
            worst, scale, d2, r2 = 0.0, 0.0, 0.0, 0.0
            for a in range(0, xs.shape[0], CHUNK):
                b = a + CHUNK
                nxt, gap = next_states(ref, num, xs[a:b], us[a:b])
                err = (got[a:b, None] - nxt).abs().amax(dim=2)
                err = torch.where(gap <= TIE, err, torch.inf)
                j = torch.argmin(err, dim=1)
                held = nxt[torch.arange(nxt.shape[0]), j]
                dx = got[a:b] - held
                worst = max(worst, float(dx.abs().max()))
                scale = max(scale, float(held.abs().max()))
                d2 += float((dx * dx).sum())
                r2 += float((held * held).sum())
            vals["step_worst"] = worst / scale
            vals["step_rel"] = math.sqrt(d2 / r2)
            for k, v in vals.items():
                v = v if math.isfinite(v) else math.inf
                out[k] = max(out.get(k, v), v)
        return out
