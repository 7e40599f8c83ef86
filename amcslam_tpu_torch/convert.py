"""Carry problems between numpy arrays and the port's tensors.

`ba_from_numpy` builds the port's `LocalBAData`/`BAState` from field name ->
numpy array mappings (the reference's field names); `pose_from_numpy` does
the same for the pose solver's `PoseGPData`/`PoseState` and
`vel_ransac_from_numpy` for `VelRansacData`. The `*from_reference`
functions take the reference package's NamedTuples through `np.asarray`
without importing JAX, so the same problem can be pushed through both
packages; `to_numpy` goes the other way.

Dtypes: integer fields become int64 (every index tensor is int64 from here
on), boolean fields stay bool, floating fields take the requested dtype.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .ransac.vel_ransac import VelRansacData
from .solver.ba import BAState, LocalBAData
from .solver.pose_solver import PoseGPData, PoseState


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int64), device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def _named(cls, fields: Mapping[str, Any], device, dtype):
    """cls from a name -> array mapping; optional fields may be missing or
    None."""
    return cls(**{k: None if fields.get(k) is None else _tensor(fields[k], device, dtype)
                  for k in cls._fields if k in fields})


def _arrays(nt) -> dict[str, np.ndarray | None]:
    return {k: None if v is None else np.asarray(v) for k, v in nt._asdict().items()}


def ba_from_numpy(data_fields: Mapping[str, Any], state_fields: Mapping[str, Any],
                  device="cpu", dtype=torch.float64) -> tuple[LocalBAData, BAState]:
    """LocalBAData + BAState from name -> array mappings."""
    return (_named(LocalBAData, data_fields, device, dtype),
            state_from_numpy(state_fields, device=device, dtype=dtype))


def state_from_numpy(state_fields: Mapping[str, Any], device="cpu",
                     dtype=torch.float64) -> BAState:
    return _named(BAState, state_fields, device, dtype)


def from_reference(data, state, device="cpu", dtype=torch.float64):
    """Port tensors from the reference package's LocalBAData/BAState (any
    NamedTuples with those field names)."""
    return ba_from_numpy(_arrays(data), _arrays(state), device=device, dtype=dtype)


def pose_from_numpy(data_fields: Mapping[str, Any], state_fields: Mapping[str, Any],
                    device="cpu", dtype=torch.float64) -> tuple[PoseGPData, PoseState]:
    """PoseGPData + PoseState from name -> array mappings."""
    return (_named(PoseGPData, data_fields, device, dtype),
            pose_state_from_numpy(state_fields, device=device, dtype=dtype))


def pose_state_from_numpy(state_fields: Mapping[str, Any], device="cpu",
                          dtype=torch.float64) -> PoseState:
    return _named(PoseState, state_fields, device, dtype)


def pose_from_reference(data, state, device="cpu", dtype=torch.float64):
    """Port tensors from the reference's PoseGPData/PoseState."""
    return pose_from_numpy(_arrays(data), _arrays(state), device=device, dtype=dtype)


def vel_ransac_from_numpy(fields: Mapping[str, Any], device="cpu",
                          dtype=torch.float64) -> VelRansacData:
    return _named(VelRansacData, fields, device, dtype)


def vel_ransac_from_reference(data, device="cpu", dtype=torch.float64) -> VelRansacData:
    """Port tensors from the reference's VelRansacData."""
    return vel_ransac_from_numpy(_arrays(data), device=device, dtype=dtype)


def to_numpy(nt) -> dict[str, np.ndarray | None]:
    """Field name -> numpy array of a port NamedTuple."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in nt._asdict().items()}
