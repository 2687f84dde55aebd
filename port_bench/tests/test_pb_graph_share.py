"""qp_build_graph_share's reader: the share of the batch-fused MPC loop's
stage bodies that ran as a CUDA graph replay, from the program's counts
(control/batch_mpc.py `StageGraphs`); None for a program without them (a
parent of the CUDA graphs) and for one that ran no stage body on a card."""

import pytest

from port_bench.harness import registry


def test_the_graph_share_reads_the_programs_counts(monkeypatch):
    from soft_robot_control_tpu_torch.control import batch_mpc

    read = registry.metric("qp_build_graph_share").read
    counts = batch_mpc.StageGraphs
    monkeypatch.setattr(counts, "replays", 0)
    monkeypatch.setattr(counts, "eager", 0)
    assert read(None) is None
    monkeypatch.setattr(counts, "replays", 4424)
    monkeypatch.setattr(counts, "eager", 63)
    assert read(None) == pytest.approx(4424 / 4487)


def test_a_program_without_the_counts_reads_none(monkeypatch):
    from soft_robot_control_tpu_torch.control import batch_mpc

    monkeypatch.delattr(batch_mpc, "StageGraphs")
    assert registry.metric("qp_build_graph_share").read(None) is None
