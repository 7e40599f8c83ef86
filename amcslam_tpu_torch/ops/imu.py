"""IMU preintegration (ImuTypes.cc `Preintegrated`), in PyTorch.

Port of `amcslam_tpu/ops/imu.py`: midpoint preintegration of gyro/accel
measurements between keyframes with first-order bias Jacobians and 15x15
covariance propagation (IntegrateNewMeasurement, ImuTypes.cc:177-235).

The reference's `lax.scan` over measurements becomes a Python loop over the
measurement axis; every function is batched over leading dimensions, so
independent windows (one per keyframe pair) integrate together, each step
one batched update. The reference's `exact` precision scope is the
package-level setting here (TF32 off, highest float32 matmul precision;
see amcslam_tpu_torch/__init__.py).

Shapes: a window's measurements are acc, gyro (..., N, 3), dts and valid
(..., N); biases (..., 3); Nga and NgaWalk (6, 6) or (..., 6, 6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie


class PreintState(NamedTuple):
    dR: torch.Tensor    # (...,3,3) integrated rotation
    dV: torch.Tensor    # (...,3)
    dP: torch.Tensor    # (...,3)
    JRg: torch.Tensor   # (...,3,3) d dR / d bias_gyro
    JVg: torch.Tensor   # (...,3,3)
    JVa: torch.Tensor   # (...,3,3)
    JPg: torch.Tensor   # (...,3,3)
    JPa: torch.Tensor   # (...,3,3)
    C: torch.Tensor     # (...,15,15) covariance [dR dV dP bg ba]
    dT: torch.Tensor    # (...,) total time


def init_state(dtype=torch.float32, batch: tuple = (), device="cpu") -> PreintState:
    """The empty preintegration of a batch of windows."""
    eye = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3)
    z3 = torch.zeros(*batch, 3, dtype=dtype, device=device)
    z33 = torch.zeros(*batch, 3, 3, dtype=dtype, device=device)
    return PreintState(dR=eye, dV=z3, dP=z3, JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
                       C=torch.zeros(*batch, 15, 15, dtype=dtype, device=device),
                       dT=torch.zeros(batch, dtype=dtype, device=device))


def integrate(state: PreintState, acc, gyro, dt, bias_g, bias_a, Nga, NgaWalk) -> PreintState:
    """One measurement step (ImuTypes.cc:177-235 order of operations); dt
    (...,) per window."""
    dtype, dev = state.dR.dtype, state.dR.device
    dt_ = dt[..., None, None]
    a = acc - bias_a
    w = gyro - bias_g
    dRa = (state.dR @ a[..., None])[..., 0]

    dP = state.dP + state.dV * dt[..., None] + 0.5 * dRa * dt[..., None] * dt[..., None]
    dV = state.dV + dRa * dt[..., None]

    Wacc = lie.hat(a)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    dR_dt = state.dR * dt_
    dR_dt2 = -0.5 * state.dR * dt_ * dt_

    JPa = state.JPa + state.JVa * dt_ - 0.5 * state.dR * dt_ * dt_
    JPg = state.JPg + state.JVg * dt_ - ((0.5 * state.dR * dt_ * dt_) @ Wacc) @ state.JRg
    JVa = state.JVa - dR_dt
    JVg = state.JVg - (dR_dt @ Wacc) @ state.JRg

    dRi = lie.exp_so3(w * dt[..., None])
    rightJ = lie.right_jacobian_so3(w * dt[..., None])
    dR = state.dR @ dRi

    zero = torch.zeros_like(state.dR)
    A = torch.cat([
        torch.cat([dRi.transpose(-1, -2), zero, zero], -1),
        torch.cat([-(dR_dt @ Wacc), eye3.expand_as(zero), zero], -1),
        torch.cat([dR_dt2 @ Wacc, dt_ * eye3, eye3.expand_as(zero)], -1),
    ], -2)  # (...,9,9)
    B = torch.cat([
        torch.cat([rightJ * dt_, zero], -1),
        torch.cat([zero, dR_dt], -1),
        torch.cat([zero, 0.5 * state.dR * dt_ * dt_], -1),
    ], -2)  # (...,9,6)

    C9 = (A @ state.C[..., :9, :9]) @ A.transpose(-1, -2) + (B @ Nga) @ B.transpose(-1, -2)
    C = state.C.clone()
    C[..., :9, :9] = C9
    C[..., 9:, 9:] = C[..., 9:, 9:] + NgaWalk

    JRg = dRi.transpose(-1, -2) @ state.JRg - rightJ * dt_
    return PreintState(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                       C=C, dT=state.dT + dt)


def preintegrate(acc, gyro, dts, bias_g, bias_a, Nga, NgaWalk, valid=None) -> PreintState:
    """Integrate (padded) measurement windows at a fixed bias estimate:
    acc/gyro (..., N, 3), dts (..., N); steps where `valid` is False leave
    the state unchanged."""
    batch = tuple(acc.shape[:-2])
    state = init_state(acc.dtype, batch, acc.device)
    if valid is None:
        valid = torch.ones(acc.shape[:-1], dtype=torch.bool, device=acc.device)
    for k in range(acc.shape[-2]):
        new = integrate(state, acc[..., k, :], gyro[..., k, :], dts[..., k], bias_g, bias_a,
                        Nga, NgaWalk)
        m = valid[..., k]
        state = PreintState(*(torch.where(m.reshape(m.shape + (1,) * (o.ndim - m.ndim)), n, o)
                              for o, n in zip(state, new)))
    return state


def delta_with_bias(pre: PreintState, dbg, dba):
    """First-order bias-corrected deltas (GetDeltaRotation/Velocity/Position):
    dR(b) = dR exp(JRg dbg); dV(b) = dV + JVg dbg + JVa dba;
    dP(b) = dP + JPg dbg + JPa dba."""
    def mv(M, x):
        return (M @ x[..., None])[..., 0]

    dR = pre.dR @ lie.exp_so3(mv(pre.JRg, dbg))
    dV = pre.dV + mv(pre.JVg, dbg) + mv(pre.JVa, dba)
    dP = pre.dP + mv(pre.JPg, dbg) + mv(pre.JPa, dba)
    return dR, dV, dP


def merge_previous(prev_meas, meas, bias_g, bias_a, Nga, NgaWalk) -> PreintState:
    """Preintegrated::MergePrevious (ImuTypes.cc:237-263): re-integrate the
    concatenation of two measurement windows at the updated bias. Each window
    is (acc (...,N,3), gyro (...,N,3), dts (...,N), valid (...,N))."""
    acc = torch.cat([prev_meas[0], meas[0]], -2)
    gyro = torch.cat([prev_meas[1], meas[1]], -2)
    dts = torch.cat([prev_meas[2], meas[2]], -1)
    valid = torch.cat([prev_meas[3], meas[3]], -1)
    return preintegrate(acc, gyro, dts, bias_g, bias_a, Nga, NgaWalk, valid)


def reintegrate(meas, bias_g, bias_a, Nga, NgaWalk) -> PreintState:
    """Preintegrated::Reintegrate: fresh integration at a new bias estimate
    (the measurements are retained, ImuTypes.cc:265-275)."""
    acc, gyro, dts, valid = meas
    return preintegrate(acc, gyro, dts, bias_g, bias_a, Nga, NgaWalk, valid)
