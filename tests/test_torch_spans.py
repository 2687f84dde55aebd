"""The port's spans (utils/timing.py `span`, `spans`): off, they give one
shared context and leave no trace in a profiler; on, the batched MPC,
GuSTO and rollout entry points mark their layers with the names and the
nesting that the benchmark's span pass reads; either way the outputs are
the same bits. On the CPU at B=8, on a made-up dictionary of 8 points."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
from soft_robot_control_tpu_torch.models.tpwl import rollout_batch
from soft_robot_control_tpu_torch.scp.gusto_jit import GuSTOJit
from soft_robot_control_tpu_torch.utils import timing

from torch_helpers import made_up_tpwl

B, P, R_DIM, NODES, CABLES, DT = 8, 8, 2, 2, 2, 0.01
N, N_REPLAN, WINDOWS, RHO_STAGES = 3, 2, 2, 2


@pytest.fixture(scope="module")
def model():
    """A TPWL dictionary of P points near the identity, discrete at DT,
    with two nodes measured and one node's position as the output."""
    return made_up_tpwl(P, R_DIM, CABLES, NODES, [0, 1], [1], dt=DT,
                        a_scale=0.5)


def _box():
    return HyperRectangle(np.ones(CABLES), -np.ones(CABLES))


@pytest.fixture(scope="module")
def fleet(model):
    """A batch-fused closed loop (condensed, rho stages) and its inputs."""
    mpc = BatchMPC(model, 10.0 * np.eye(3), 1e-2 * np.eye(CABLES), N=N,
                   dt=DT, N_replan=N_REPLAN, U=_box(), qp_iters=4,
                   x_step="kinv", formulation="condensed", scaling_iters=2,
                   rho_stages=RHO_STAGES, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x0 = 0.1 * torch.randn((B, 2 * R_DIM), generator=gen, dtype=torch.float64)
    zt = 0.1 * torch.randn((B, WINDOWS, N + 1, 3), generator=gen,
                           dtype=torch.float64)
    noise = torch.randn((WINDOWS, N_REPLAN, B, 12), generator=gen,
                        dtype=torch.float64)
    run = mpc.build_fused(WINDOWS, noise_std=0.01)
    return lambda: run(x0, x0, zt, noise)


def _gusto(model):
    gj = GuSTOJit(TPWLGuSTO(model), N=N, dt=DT, Qz=10.0 * np.eye(3),
                  R=1e-2 * np.eye(CABLES), U=_box(), max_iters=2, qp_iters=4,
                  x_step="kinv", formulation="sparse", dtype=torch.float64)
    gen = torch.Generator().manual_seed(2)
    x0 = 0.1 * torch.randn((B, 2 * R_DIM), generator=gen, dtype=torch.float64)
    args = (x0, torch.zeros((B, N, CABLES), dtype=torch.float64),
            x0[:, None].expand(-1, N + 1, -1).clone(),
            0.1 * torch.randn((B, N + 1, 3), generator=gen,
                              dtype=torch.float64))
    return lambda: tuple(gj.solve_batch_fused(*args))


def _rollouts(model):
    gen = torch.Generator().manual_seed(3)
    x0 = 0.1 * torch.randn((B, 2 * R_DIM), generator=gen, dtype=torch.float64)
    u = torch.rand((B, 5, CABLES), generator=gen, dtype=torch.float64)
    return lambda: rollout_batch(model, x0, u, DT, select="exact")


def _annotations(fn):
    """[(name, start, end)] of the user annotations a CPU profiler records
    around fn(), in the order they start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """The innermost span around each span (None for a root)."""
    out, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][2] < e:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
        stack.append((name, s, e))
    return out


def test_spans_off_are_one_shared_context_and_leave_no_trace(fleet):
    assert not timing._spans_on
    assert timing.span("mpc.window") is timing.span("qp.kinv")
    assert _annotations(fleet) == []
    with timing.spans():
        with timing.spans(on=False):
            assert _annotations(fleet) == []
        assert timing.span("a") is not timing.span("a")
    assert not timing._spans_on


def test_spans_on_give_the_layers_names_nesting_and_counts(fleet):
    with timing.spans():
        spans = _annotations(fleet)
    names = [s[0] for s in spans]
    pairs = set(zip(names, _parents(spans)))
    count = {n: names.count(n) for n in set(names)}
    assert count == {"mpc.call": 1, "mpc.window": WINDOWS,
                     "qp.assemble": WINDOWS, "qp.ruiz": WINDOWS,
                     "qp.kinv": WINDOWS * RHO_STAGES,
                     "qp.rho": WINDOWS * (RHO_STAGES - 1),
                     "qp.recover": WINDOWS,
                     "mpc.tick": WINDOWS * N_REPLAN,
                     "tpwl.select": WINDOWS * (1 + N_REPLAN),
                     "ekf.correct": WINDOWS * N_REPLAN}
    assert pairs == {("mpc.call", None), ("mpc.window", "mpc.call"),
                     ("mpc.tick", "mpc.call"),
                     ("tpwl.select", "mpc.window"),
                     ("tpwl.select", "mpc.tick"),
                     ("ekf.correct", "mpc.tick")} | {
        (n, "mpc.window") for n in ("qp.assemble", "qp.ruiz", "qp.kinv",
                                     "qp.rho", "qp.recover")}


def test_gusto_and_rollout_spans(model):
    with timing.spans():
        gusto = [s[0] for s in _annotations(_gusto(model))]
        roll = _annotations(_rollouts(model))
    assert gusto.count("gusto.call") == 1 and gusto[0] == "gusto.call"
    assert gusto.count("gusto.iteration") == 2
    assert gusto.count("qp.assemble") == gusto.count("qp.kinv") == 2
    assert [s[0] for s in roll] == ["tpwl.rollout"] + ["tpwl.select"] * 5
    assert _parents(roll)[1:] == ["tpwl.rollout"] * 5


@pytest.mark.parametrize("entry", ["fleet", "gusto", "rollouts"])
def test_spans_on_and_off_give_the_same_bits(entry, model, fleet):
    fn = {"fleet": lambda: fleet, "gusto": lambda: _gusto(model),
          "rollouts": lambda: _rollouts(model)}[entry]()
    off = fn()
    with timing.spans():
        on = fn()
    flat = lambda o: (list(o.values()) if isinstance(o, dict)
                      else list(o) if isinstance(o, tuple) else [o])
    assert all(torch.equal(a, b) for a, b in zip(flat(off), flat(on)))
    assert len(flat(off)) == len(flat(on)) >= 1


def test_trace_writes_the_spans(fleet, tmp_path):
    with timing.trace(str(tmp_path)):
        fleet()
    assert not timing._spans_on
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "mpc.window" for e in events)
