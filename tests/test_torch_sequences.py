"""The port's copy of control/sequences.py against the JAX package's: the
maximin Latin Hypercube and every robot sequence, from the same numpy
seeds, bit-identical (both are numpy; the port keeps its own copy so that
it imports nothing of the JAX package)."""

import numpy as np
import pytest

from soft_robot_control_tpu.control import sequences as jseq
from soft_robot_control_tpu_torch.control import sequences as tseq

import torch_helpers  # noqa: F401  (single-threaded torch)


def _same(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        assert np.array_equal(x, y)


@pytest.mark.parametrize("n_dims,samples,candidates", [
    (4, 15, 20), (8, 10, 20), (1, 1, 3), (3, 40, 5)])
def test_lhs_maximin_is_the_jax_packages(n_dims, samples, candidates):
    got = tseq.lhs_maximin(n_dims, samples, np.random.default_rng(11),
                           candidates)
    ref = jseq.lhs_maximin(n_dims, samples, np.random.default_rng(11),
                           candidates)
    assert np.array_equal(got, ref)
    # a Latin Hypercube: one sample in each of `samples` strata a dimension
    strata = np.sort(np.floor(got * samples), axis=0)
    assert np.array_equal(strata, np.tile(np.arange(samples)[:, None],
                                          (1, n_dims)))


SEQUENCES = [
    ("DiamondRobotSequences", dict(dt=0.02, t0=1.0)),
    ("TrunkRobotSequences", dict(dt=0.02, t0=1.0)),
    ("TrunkRobotLongCablesOnlySequences", dict(dt=0.01, t0=0.5)),
    ("FingerRobotSequences", dict(dt=0.01, t0=1.0)),
]

CALLS = [
    ("lhs_sequence", dict(nbr_samples=15, t_step=0.3, seed=1)),
    ("lhs_sequence", dict(nbr_samples=6, t_step=0.1, interp_pts=2,
                          nbr_zeros=2, static=True, seed=5)),
    ("lhs_sequence", dict(nbr_samples=4, add_base=False, seed=None)),
    ("individual_actuation", dict(t_step=0.1, interp_pts=1)),
    ("sine_input", dict(u_max=None, t=0.5)),
    ("constant_input", dict(u_constant=None, t=0.3, save_data=True)),
    ("traj_tracking", dict()),
]


@pytest.mark.parametrize("cls,kw", SEQUENCES)
@pytest.mark.parametrize("method,args", CALLS)
def test_robot_sequences_are_the_jax_packages(cls, kw, method, args):
    """Each robot's sequences from the same seed: u, save and t sequences
    equal to the bit. seed=None draws from the OS: there the shapes and
    the base prefix are compared."""
    j, t = getattr(jseq, cls)(**kw), getattr(tseq, cls)(**kw)
    _same((j.u_base, j.save_base), (t.u_base, t.save_base))
    args = dict(args)
    for k in ("u_max", "u_constant"):
        if k in args:
            args[k] = np.linspace(100.0, 400.0, j.m)
    if method == "traj_tracking" and cls == "TrunkRobotLongCablesOnlySequences":
        for s in (j, t):
            with pytest.raises(NotImplementedError):
                s.traj_tracking()
        return
    got, ref = getattr(t, method)(**args), getattr(j, method)(**args)
    if args.get("seed", 0) is None:
        assert [np.shape(a) for a in got] == [np.shape(a) for a in ref]
        return
    _same(got, ref)
    assert t.name == j.name


def test_combined_sequence_with_times():
    j, t = jseq.DiamondRobotSequences(dt=0.02), tseq.DiamondRobotSequences(dt=0.02)
    us = [np.ones((4, 3)), 2 * np.ones((4, 2))]
    ss = [np.ones(3, bool), np.zeros(2, bool)]
    ts = [np.arange(3) * 0.02, np.arange(2) * 0.02 + 5.0]
    _same(t.combined_sequence(us, ss, ts), j.combined_sequence(us, ss, ts))
