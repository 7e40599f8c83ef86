"""Robust kernels with g2o-compatible semantics (port of
`amcslam_tpu/solver/robust.py`).

chi2 contribution = rho0(s), H/b weighting = rho1(s) * information, with
s = e^T Omega e; `enabled=False` reproduces `setRobustKernel(0)`.
Elementwise over any batch shape.
"""

from __future__ import annotations

import torch


def _scalar(x, dtype, device) -> torch.Tensor:
    """`torch.as_tensor(x, dtype=dtype, device=device)` without a copy from
    the host for a Python number (a fill on the device), which a CUDA graph
    capture does not allow."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.full((), x, dtype=dtype, device=device)


def huber_rho01(s: torch.Tensor, delta, enabled) -> tuple[torch.Tensor, torch.Tensor]:
    """(rho0, rho1) of the Huber kernel at squared error s.

    Inlier (s <= delta^2): rho0 = s,                rho1 = 1
    Outlier:               rho0 = 2 delta sqrt(s) - delta^2,
                           rho1 = delta / sqrt(s)
    `delta` and `enabled` are scalars or tensors broadcastable to s.
    """
    delta = _scalar(delta, s.dtype, s.device)
    enabled = _scalar(enabled, torch.bool, s.device)
    dsqr = delta * delta
    inlier = s <= dsqr
    sqrte = torch.sqrt(torch.clamp_min(s, torch.finfo(s.dtype).tiny))
    ones = torch.ones_like(s)
    rho0 = torch.where(inlier, s, 2.0 * sqrte * delta - dsqr)
    rho1 = torch.where(inlier, ones, delta / sqrte)
    rho0 = torch.where(enabled, rho0, s)
    rho1 = torch.where(enabled, rho1, ones)
    return rho0, rho1
