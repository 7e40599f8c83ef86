"""amcslam_tpu_torch — the PyTorch/CUDA port of amcslam_tpu.

A second implementation of the asynchronous multi-camera SLAM backend, for
one NVIDIA H100, beside the JAX reference package `amcslam_tpu/`. It imports
torch and numpy only, never JAX and never the reference package, so it runs
on machines where JAX is not installed. Each module names its JAX
counterpart by path and is tested against it (tests/test_torch_*.py).

Layout (mirrors the reference):
  ops/       SO(3)/SE(3)/Sim(3) Lie groups, the WNOA GP, IMU preintegration,
             the GP-interpolation chain (hand-written CUDA kernel in
             csrc/interp_chain.cu)
  factors/   residual + analytic-Jacobian factors, batched over edges
  solver/    robust kernels, the g2o-exact LM loop, the local/global GP-BA
             (dense and PCG), the pose solver, Sim3 and VI optimizers
  ransac/    MC-RANSAC, MLPnP, Sim3 RANSAC, two-view initialization
  pipeline/  the System: tracking, local mapping, loop closing, the map
  frontend/  ORB on the host (csrc/orb_fast.cpp) and on the device, cameras
  parallel/  the landmark-sharded BA and edge-sharded essential graph over
             torch.distributed ranks
  examples/  the user entry points and the profiling scripts
  utils/     shape buckets, the synthetic problem generator, I/O, timing
  entry.py   the entry points of __graft_entry__.py (one LM iteration,
             the multi-device dry run)
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
