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


def _copy(a):
    return None if a is None else np.array(a, copy=True)


def _copy_list(xs):
    return None if xs is None else [_copy(x) for x in xs]


def atlas_from_reference(atlas):
    """The port's Atlas/Map/KeyFrame/MapPoint/GPObs graph rebuilt from a
    reference `Atlas` by attribute (nothing of the reference is imported):
    ids, kf_seq, the prev_kf/next_kf/parent links, covisibility,
    observations and GP observations are kept, every array is copied. The
    pipeline's counterpart of `from_reference`, so both packages can run
    extraction and tracking from one map."""
    from .pipeline import map_store as ms

    kfs: dict[int, ms.KeyFrame] = {}

    def keyframe(k):
        if k is None:
            return None
        if k.id not in kfs:
            kfs[k.id] = ms.KeyFrame(
                timestamp=k.timestamp, cam_times=_copy(k.cam_times), Twb=_copy(k.Twb),
                velocity=_copy(k.velocity), keypoints=_copy_list(k.keypoints),
                kp_octaves=_copy_list(k.kp_octaves), descriptors=_copy_list(k.descriptors),
                kp_ur=_copy(k.kp_ur), kp_depth=_copy(k.kp_depth),
                kp_angles=_copy_list(k.kp_angles), id=k.id, kf_seq=k.kf_seq,
                matches=_copy(k.matches), covisibility=dict(k.covisibility),
                loop_edges=[(i, _copy(C)) for i, C in k.loop_edges], bad=k.bad,
                bow=None if k.bow is None else dict(k.bow),
                kp_sigma2_scale=_copy_list(getattr(k, "kp_sigma2_scale", None)),
            )
        return kfs[k.id]

    def map_point(p):
        return ms.MapPoint(
            position=_copy(p.position), descriptor=_copy(p.descriptor), id=p.id,
            observations={k: _copy(s) for k, s in p.observations.items()},
            gp_observations=[
                (k, ms.GPObs(time=o.time, cam=o.cam, uv=_copy(o.uv), ur=o.ur,
                             octave=o.octave, sigma2_scale=getattr(o, "sigma2_scale", 1.0)))
                for k, o in p.gp_observations],
            normal=_copy(p.normal), min_dist=p.min_dist, max_dist=p.max_dist,
            n_visible=p.n_visible, n_found=p.n_found, bad=p.bad, first_kf_id=p.first_kf_id,
        )

    def map_(m):
        out = ms.Map(m.id)
        out.change_index = m.change_index
        out._kf_seq = m._kf_seq
        out.keyframes = {i: keyframe(k) for i, k in m.keyframes.items()}
        out.map_points = {i: map_point(p) for i, p in m.map_points.items()}
        out.origin_kf = keyframe(m.origin_kf)
        return out

    out = ms.Atlas()
    out.maps = [map_(m) for m in atlas.maps]
    out.active = out.maps[[m is atlas.active for m in atlas.maps].index(True)]
    out.cameras = list(atlas.cameras)
    # the links last: a link may name a keyframe outside every map's table
    pending = [k for m in atlas.maps for k in m.keyframes.values()]
    while pending:
        k = pending.pop()
        port_kf = keyframe(k)
        for name in ("prev_kf", "next_kf", "parent"):
            ref_link = getattr(k, name)
            if ref_link is not None and ref_link.id not in kfs:
                pending.append(ref_link)
            setattr(port_kf, name, keyframe(ref_link))
    return out


def fetch(*tensors, dtype) -> list[np.ndarray]:
    """Host copies of device tensors in one device-to-host read, all in
    `dtype` (bool masks come back as 0/1; integer counts exactly while they
    fit the dtype's mantissa)."""
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(tuple(t.shape)))
        o += t.numel()
    return out


def to_numpy(nt) -> dict[str, np.ndarray | None]:
    """Field name -> numpy array of a port NamedTuple."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in nt._asdict().items()}
