"""Carry a local-BA problem between numpy arrays and the port's tensors.

`ba_from_numpy` builds the port's `LocalBAData`/`BAState` from field name ->
numpy array mappings (the reference's field names); `from_reference` takes
the reference package's NamedTuples (`amcslam_tpu.solver.ba.LocalBAData`,
`BAState`) through `np.asarray` without importing JAX, so the same problem
can be pushed through both packages; `to_numpy` goes the other way.

Dtypes: integer fields become int64 (every index tensor is int64 from here
on), boolean fields stay bool, floating fields take the requested dtype.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .solver.ba import BAState, LocalBAData


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int64), device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def ba_from_numpy(data_fields: Mapping[str, Any], state_fields: Mapping[str, Any],
                  device="cpu", dtype=torch.float64) -> tuple[LocalBAData, BAState]:
    """LocalBAData + BAState from name -> array mappings. Optional data
    fields may be missing or None."""
    data = LocalBAData(**{
        k: None if data_fields.get(k) is None else _tensor(data_fields[k], device, dtype)
        for k in LocalBAData._fields if k in data_fields
    })
    return data, state_from_numpy(state_fields, device=device, dtype=dtype)


def state_from_numpy(state_fields: Mapping[str, Any], device="cpu",
                     dtype=torch.float64) -> BAState:
    return BAState(**{k: _tensor(state_fields[k], device, dtype) for k in BAState._fields})


def from_reference(data, state, device="cpu", dtype=torch.float64):
    """Port tensors from the reference package's LocalBAData/BAState (any
    NamedTuples with those field names)."""
    return ba_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in data._asdict().items()},
        {k: np.asarray(v) for k, v in state._asdict().items()},
        device=device, dtype=dtype,
    )


def to_numpy(nt) -> dict[str, np.ndarray | None]:
    """Field name -> numpy array of a port NamedTuple (BAState, LocalBAData)."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in nt._asdict().items()}
