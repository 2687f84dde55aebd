"""Share of the batch-fused MPC loop's stage bodies (the QP build's spans and
the ticks' bodies) that ran as a CUDA graph replay, over the whole run's
process: replays over replays and bodies run as they are on the card (the
warm-up call at each batch size, the side-stream runs before a capture).
Read from control/batch_mpc.py's `StageGraphs` counts; None for a program
without them, or one that ran no stage body on a card."""

from soft_robot_control_tpu_torch.control import batch_mpc


def read(ctx):
    counts = getattr(batch_mpc, "StageGraphs", None)
    if counts is None:
        return None
    total = counts.replays + counts.eager
    return counts.replays / total if total else None
