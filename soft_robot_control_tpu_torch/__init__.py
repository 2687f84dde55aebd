"""PyTorch/CUDA port of soft_robot_control_tpu.

The same layout and public names as the JAX package, with PyTorch tensors
in place of JAX arrays: ``vmap`` becomes an explicit leading batch axis and
``scan`` a Python loop. The two TPU kernels of the batched MPC path are
hand-written CUDA for Hopper (``ops/``, sources in ``csrc/``).

Precision is part of the contract: the JAX package runs every contraction
at ``Precision.HIGHEST``, so TF32 is switched off for matmuls and cuDNN.
Entry points take ``device=`` (default ``"cuda"``) and raise when no card
is present instead of running on the CPU.

This package imports neither ``jax`` nor ``soft_robot_control_tpu``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from soft_robot_control_tpu_torch.core import (constraints, discretize,  # noqa: E402,F401
                                               packing, types)
