"""amcslam_tpu_torch — the PyTorch/CUDA port of amcslam_tpu.

A second implementation of the asynchronous multi-camera SLAM backend, for
one NVIDIA H100, beside the JAX reference package `amcslam_tpu/`. It imports
torch and numpy only, never JAX and never the reference package, so it runs
on machines where JAX is not installed. Each module names its JAX
counterpart by path and is tested against it (tests/test_torch_*.py).

Layout (mirrors the reference):
  ops/       SO(3)/SE(3) Lie groups, the WNOA GP, the GP-interpolation chain
             (hand-written CUDA kernel in csrc/interp_chain.cu)
  factors/   residual + analytic-Jacobian factors, batched over edges
  solver/    robust kernels, the g2o-exact LM loop, the local GP-BA
  utils/     shape buckets, the synthetic problem generator
  convert.py carries a reference problem (numpy arrays) into torch tensors

This module replaces `amcslam_tpu/ops/precision.py` and the reference's
`jax_default_matmul_precision` global (amcslam_tpu/__init__.py:23-28).
"""

import torch as _torch

__version__ = "0.1.0"

# SLAM geometry is precision-critical: a TF32 matmul keeps ~10 mantissa bits,
# which puts ~1e-3 absolute error into 4x4 pose compositions and the Schur
# complement — far above the solver's chi2 parity budget. Keep every float32
# matmul and convolution in true float32 on the card.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
