"""Debug scaffolding: edge dumps and a numerical Jacobian check.

Port of `amcslam_tpu/solver/debug.py`, the counterpart of the reference's
GetJacobian / GetHessian dumps (G2oTypes.h:167-396), `Optimizer::saveMatrix`
(Optimizer.cc:688-711) and `jacobianNumercialDiff` (Pose3utils.cc:82-109),
on tensors of any device (values are read back to numpy where they are
compared or written).
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_matrix(path: str, matrix) -> None:
    """CSV dump (Optimizer::saveMatrix parity)."""
    np.savetxt(path, _np(matrix), delimiter=",")


def numerical_jacobian(residual_fn, retract_fn, state, dim: int, h: float = 1e-6,
                       like: torch.Tensor | None = None):
    """Central-difference Jacobian of residual_fn at `state` with respect to
    the retraction `retract_fn(state, d)`, d a (dim,) tensor of the dtype and
    device of `like` (float64 on the CPU by default). Returns a numpy array
    (..., dim)."""
    dtype = torch.float64 if like is None else like.dtype
    device = "cpu" if like is None else like.device
    cols = []
    for k in range(dim):
        d = torch.zeros(dim, dtype=dtype, device=device)
        d[k] = h
        rp = _np(residual_fn(retract_fn(state, d)))
        rm = _np(residual_fn(retract_fn(state, -d)))
        cols.append((rp - rm) / (2 * h))
    return np.stack(cols, axis=-1)


def check_jacobian(residual_fn, retract_fn, state, analytic, dim: int,
                   atol: float = 1e-6, h: float = 1e-6, like: torch.Tensor | None = None):
    """Compare an analytic Jacobian with central differences; returns
    (max_abs_err, numeric_jacobian)."""
    J_num = numerical_jacobian(residual_fn, retract_fn, state, dim, h, like)
    return float(np.abs(_np(analytic) - J_num).max()), J_num


def edge_hessian(J_blocks, information):
    """GetHessian parity: J^T Omega J of a concatenated edge Jacobian."""
    J = torch.cat(list(J_blocks), -1)
    return J.transpose(-1, -2) @ torch.as_tensor(information, dtype=J.dtype, device=J.device) @ J
