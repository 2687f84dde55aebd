"""Open-loop excitation sequence design, in numpy on the host.

The port's own copy of the JAX package's control/sequences.py (which is
numpy too): constant, sine, per-cable individual actuation, Latin-Hypercube
step/ramp sequences, the robots' trajectory-tracking primitives (Trunk
figure-8 "infinity sign", Diamond periodic sine, Finger sine), and
concatenation behind a settle-time base prefix (sofacontrol/
open_loop_sequences.py). The maximin Latin Hypercube sampler takes a
`np.random.Generator`, so the same seed gives the same sequences in both
packages. u_sequence is (m, T), as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def lhs_maximin(n_dims: int, samples: int, rng: np.random.Generator,
                candidates: int = 20) -> np.ndarray:
    """Maximin Latin Hypercube in [0,1]^n_dims.

    Draws `candidates` random LHS designs and keeps the one with the largest
    minimum pairwise distance — the same 'm' criterion pyDOE implements.
    """
    best, best_score = None, -np.inf
    for _ in range(candidates):
        # one random LHS: stratified samples, independently permuted per dim
        cut = (np.arange(samples)[:, None] + rng.random((samples, n_dims))) / samples
        design = np.empty_like(cut)
        for j in range(n_dims):
            design[:, j] = rng.permutation(cut[:, j])
        if samples > 1:
            diff = design[:, None, :] - design[None, :, :]
            dist = np.sqrt((diff**2).sum(-1))
            np.fill_diagonal(dist, np.inf)
            score = dist.min()
        else:
            score = 0.0
        if score > best_score:
            best, best_score = design, score
    return best


class BaseRobotSequences:
    """Excitation sequence factory (open_loop_sequences.py:8-241)."""

    def __init__(self, m, u0=None, umax=None, umin=None, dt=0.01, t0=0):
        self.m = m
        self.dt = dt
        self.u0 = np.zeros(m) if u0 is None else np.asarray(u0, dtype=float)
        self.umax = umax
        self.umin = umin
        self.t0 = t0
        self.u_base, self.save_base, _ = self.constant_input(self.u0, self.t0,
                                                             add_base=False)
        self.save_base[-5:] = True
        self.active_inputs = None
        self.name = None

    # ------------------------------------------------------------------
    def constant_input(self, u_constant, t, add_base=True, save_data=False):
        self.name = "constant"
        num_steps = int(t / self.dt)
        u_constant = np.asarray(u_constant, dtype=float)
        if u_constant.shape[0] != self.m or u_constant.ndim != 1:
            raise AssertionError("Dimension mismatch for control input")
        u_sequence = np.broadcast_to(u_constant[:, None], (self.m, num_steps)).copy()
        save_sequence = np.array([save_data] * num_steps)
        if add_base:
            u_sequence, save_sequence = self.combined_sequence(
                [self.u_base, u_sequence], [self.save_base, save_sequence])
        t_sequence = self.dt * np.arange(u_sequence.shape[1])
        return u_sequence, save_sequence, t_sequence

    def augment_input_with_base(self, u_seq, save_data=True):
        save_sequence = np.array([save_data] * u_seq.shape[1])
        u_sequence, save_sequence = self.combined_sequence(
            [self.u_base, u_seq], [self.save_base, save_sequence])
        t_sequence = self.dt * np.arange(u_sequence.shape[1])
        return u_sequence, save_sequence, t_sequence

    def sine_input(self, u_max, t, add_base=True):
        """Half-period sine envelope on all channels (sequences.py:75-95)."""
        self.name = "sine"
        num_steps = int(t / self.dt)
        u_max = np.asarray(u_max, dtype=float)
        env = np.sin(np.linspace(0, np.pi, num_steps))
        u_sequence = u_max[:, None] * env[None, :]
        save_sequence = np.array([False] * num_steps)
        if add_base:
            u_sequence, save_sequence = self.combined_sequence(
                [self.u_base, u_sequence], [self.save_base, save_sequence])
        t_sequence = self.dt * np.arange(u_sequence.shape[1])
        return u_sequence, save_sequence, t_sequence

    def individual_actuation(self, t_step=None, interp_pts=0, add_base=True,
                             static=False):
        """Actuate each active cable one at a time: u0 -> umax -> (umin) -> u0
        staircase (sequences.py:97-146)."""
        self.name = "individual"
        active = np.asarray(self.active_inputs, dtype=bool)
        u0 = self.u0[active]
        if t_step is None:
            t_step = self.dt
        seq = []
        umax_a, umin_a = np.asarray(self.umax)[active], np.asarray(self.umin)[active]
        for i in range(active.sum()):
            hi = u0.copy()
            hi[i] += umax_a[i]
            seq.append(hi)
            if umin_a[i] != 0:
                lo = u0.copy()
                lo[i] += umin_a[i]
                seq.append(lo)
            seq.append(u0.copy())
        seq = np.asarray(seq)
        seq, save_sequence = self.interpolate_and_repeat_step_sequence(
            seq, u0, interp_pts=interp_pts, steps_per_seq=int(t_step / self.dt),
            static=static)
        u_sequence = np.repeat(self.u0.reshape(-1, 1), seq.shape[0], axis=1)
        u_sequence[active, :] = seq.T
        if add_base:
            u_sequence, save_sequence = self.combined_sequence(
                [self.u_base, u_sequence], [self.save_base, save_sequence])
        t_sequence = self.dt * np.arange(u_sequence.shape[1])
        return u_sequence, save_sequence, t_sequence

    def lhs_sequence(self, nbr_samples=30, t_step=None, interp_pts=0,
                     nbr_zeros=0, add_base=True, static=False,
                     seed: Optional[int] = None):
        """Latin-Hypercube staircase excitation (sequences.py:148-193)."""
        self.name = "lhs"
        rng = np.random.default_rng(seed)
        active = np.asarray(self.active_inputs, dtype=bool)
        u0 = self.u0[active]
        if t_step is None:
            t_step = self.dt
        n_active = int(active.sum())
        umax_a, umin_a = np.asarray(self.umax)[active], np.asarray(self.umin)[active]
        seq = u0 + umin_a + (umax_a - umin_a) * lhs_maximin(n_active, nbr_samples, rng)
        if nbr_zeros > 0:
            idx = rng.choice(nbr_samples, size=nbr_zeros, replace=False)
            seq = np.insert(seq, np.sort(idx), u0, axis=0)
        seq, save_sequence = self.interpolate_and_repeat_step_sequence(
            seq, u0, interp_pts=interp_pts, steps_per_seq=int(t_step / self.dt),
            static=static)
        u_sequence = np.repeat(self.u0.reshape(-1, 1), seq.shape[0], axis=1)
        u_sequence[active, :] = seq.T
        if add_base:
            u_sequence, save_sequence = self.combined_sequence(
                [self.u_base, u_sequence], [self.save_base, save_sequence])
        t_sequence = self.dt * np.arange(u_sequence.shape[1])
        return u_sequence, save_sequence, t_sequence

    @staticmethod
    def interpolate_and_repeat_step_sequence(seq, u0, interp_pts=0,
                                             steps_per_seq=1, static=False):
        """Interpolate between samples and repeat into a staircase
        (sequences.py:195-222)."""
        seq = np.vstack((u0, seq))
        n = seq.shape[0]
        t_old = np.arange(n)
        t_new = np.linspace(0, n - 1, (interp_pts + 1) * (n - 1) + 1)
        seq = np.stack([np.interp(t_new, t_old, seq[:, j]) for j in range(seq.shape[1])],
                       axis=1)
        seq = np.concatenate((seq[0:1], np.repeat(seq[1:], steps_per_seq, axis=0)),
                             axis=0)
        if static:
            save_seq = np.zeros(seq.shape[0], dtype=bool)
            save_seq[::steps_per_seq] = True
        else:
            save_seq = np.ones(seq.shape[0], dtype=bool)
        return seq, save_seq

    def combined_sequence(self, u_sequences, save_sequences, t_sequences=None):
        u_sequence = np.concatenate(u_sequences, axis=1)
        save_sequence = np.concatenate(save_sequences, axis=0)
        if t_sequences is None:
            return u_sequence, save_sequence
        t_sequences = [np.asarray(t) for t in t_sequences]
        for i in range(1, len(t_sequences)):
            t_sequences[i] = (t_sequences[i] - t_sequences[i][0]
                              + t_sequences[i - 1][-1] + self.dt)
        return u_sequence, save_sequence, np.concatenate(t_sequences, axis=0)

    def traj_tracking(self, generation_method):
        raise NotImplementedError("Must be subclassed")


class FingerRobotSequences(BaseRobotSequences):
    """1-cable finger (open_loop_sequences.py:244-275)."""

    def __init__(self, dt=0.01, t0=0.0):
        m = 1
        super().__init__(m, u0=np.zeros(m), umax=2000 * np.ones(m),
                         umin=np.zeros(m), dt=dt, t0=t0)
        self.active_inputs = [True] * self.m

    def traj_tracking(self, generation_method="periodic_input", add_base=False,
                      **kwargs):
        if generation_method != "periodic_input":
            raise NotImplementedError(generation_method)
        input_mean = kwargs.get("input_mean", 1000.0)
        amplitude = kwargs.get("amplitude", 1000.0)
        period = kwargs.get("period", 5)
        repetitions = kwargs.get("repetitions", 1)
        sine = input_mean + amplitude * np.sin(
            np.linspace(0, 2 * repetitions * np.pi, int(period / self.dt * repetitions)))
        u_sequence = sine.reshape(1, -1)
        save_sequence = np.ones(u_sequence.shape[1], dtype=bool)
        if add_base:
            u_sequence, save_sequence = self.combined_sequence(
                [self.u_base, u_sequence], [self.save_base, save_sequence])
        t_sequence = self.dt * np.arange(u_sequence.shape[1])
        return u_sequence, save_sequence, t_sequence


class TrunkRobotSequences(BaseRobotSequences):
    """8-cable trunk (open_loop_sequences.py:278-324)."""

    def __init__(self, dt=0.01, t0=0.0, max_amplitude=800):
        m = 8
        super().__init__(m, u0=np.zeros(m), umax=max_amplitude * np.ones(m),
                         umin=np.zeros(m), dt=dt, t0=t0)
        self.active_inputs = [True] * self.m

    def traj_tracking(self, generation_method="infinity_sign", add_base=False,
                      **kwargs):
        self.name = "traj_tracking"
        if generation_method != "infinity_sign":
            raise NotImplementedError(generation_method)
        amplitude = kwargs.get("amplitude", 500.0)
        period = kwargs.get("period", 2.5)
        repetitions = kwargs.get("repetitions", 2)
        T = int(period * repetitions / self.dt)
        hi = amplitude * np.sin(np.linspace(0.0, 2 * repetitions * np.pi, T))
        lo = amplitude * np.sin(np.linspace(0.0, repetitions * np.pi, T))
        inf_in = np.zeros((T, 8))
        inf_in[:, 4] = np.maximum(0, -hi)
        inf_in[:, 6] = np.maximum(0, hi)
        inf_in[:, 5] = np.maximum(0, lo)
        inf_in[:, 7] = np.maximum(0, -lo)
        inf_in[:, 0] = np.maximum(0, -hi / 2.0)
        inf_in[:, 2] = hi / 2.0
        inf_in[:, 1] = lo / 2.0
        inf_in[:, 3] = -lo / 2.0
        u_sequence = inf_in.T + self.u0.reshape(-1, 1)
        save_sequence = np.ones(u_sequence.shape[1], dtype=bool)
        if add_base:
            u_sequence, save_sequence = self.combined_sequence(
                [self.u_base, u_sequence], [self.save_base, save_sequence])
        t_sequence = self.dt * np.arange(u_sequence.shape[1])
        return u_sequence, save_sequence, t_sequence


class TrunkRobotLongCablesOnlySequences(BaseRobotSequences):
    """4-long-cable trunk variant (open_loop_sequences.py:327-338)."""

    def __init__(self, dt=0.01, t0=0.0):
        m = 4
        super().__init__(m, u0=np.zeros(m), umax=800 * np.ones(m),
                         umin=np.zeros(m), dt=dt, t0=t0)
        self.active_inputs = [True] * self.m

    def traj_tracking(self, generation_method=None):
        raise NotImplementedError("Not implemented")


class DiamondRobotSequences(BaseRobotSequences):
    """4-cable diamond (open_loop_sequences.py:341-379)."""

    def __init__(self, dt=0.01, t0=0.0):
        m = 4
        super().__init__(m, u0=np.zeros(m), umax=1500.0 * np.ones(m),
                         umin=np.zeros(m), dt=dt, t0=t0)
        self.active_inputs = [True] * m

    def traj_tracking(self, generation_method="periodic_input", add_base=False,
                      **kwargs):
        if generation_method != "periodic_input":
            raise NotImplementedError(generation_method)
        input_mean = kwargs.get("input_mean", 0)
        amplitude = kwargs.get("amplitude", 1500.0)
        period = kwargs.get("period", 5)
        repetitions = kwargs.get("repetitions", 1)
        T = int(period * repetitions / self.dt)
        sine = input_mean + amplitude * np.sin(np.linspace(0, 2 * repetitions * np.pi,
                                                           int(period / self.dt * repetitions)))
        sine_in = np.zeros((T, self.m))
        sine_in[:, 0] = np.maximum(0, sine)
        sine_in[:, 1] = np.maximum(0, sine)
        sine_in[:, 2] = -np.minimum(0, sine)
        sine_in[:, 3] = -np.minimum(0, sine)
        u_sequence = sine_in.T + self.u0.reshape(-1, 1)
        save_sequence = np.ones(u_sequence.shape[1], dtype=bool)
        if add_base:
            u_sequence, save_sequence = self.combined_sequence(
                [self.u_base, u_sequence], [self.save_base, save_sequence])
        t_sequence = self.dt * np.arange(u_sequence.shape[1])
        return u_sequence, save_sequence, t_sequence
