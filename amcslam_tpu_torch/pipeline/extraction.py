"""Map-store -> device-solver problem extraction (and write-back).

Port of `amcslam_tpu/pipeline/extraction.py`. The SoA "graph builder": walks
the host map exactly the way the reference's Optimizer entry points walk
theirs (temporal window via prev_kf, fixed covisible anchors,
per-observation edges by camera type) and builds the same padded numpy
arrays as the reference, field for field; `convert.ba_from_numpy` /
`convert.pose_from_numpy` then carry them onto the caller's device and
dtype in one step (index fields int64, masks bool). The landmark gather
tables are built from the same host arrays before the carry, so nothing is
read back from the device.

The high-water shape buckets are the reference's: the shapes compare with
its arrays one for one, and fixed shapes are what a CUDA-graph capture of
the solver would need.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..solver.ba import build_interp_tables, make_landmark_tables, make_structure_ids
from ..utils.shapes import bucket_pow2
from .map_store import Frame, KeyFrame, Map
from .rig import Rig

# close-point chi2 relaxation threshold: trackDepth < 10 m
# (Optimizer.cc:442-524 bClose)
CLOSE_DEPTH_TH = 10.0


def _bucket(n: int, minimum: int = 16, factor: int = 2) -> int:
    return bucket_pow2(n, minimum, factor)


# High-water padding per shape dimension (the reference's, extraction.py:35-
# 51): monotone per-process maxima, so a dimension's padded size changes only
# when it outgrows its historical maximum.
_HIGH_WATER: dict[str, int] = {}


def _hw_bucket(key: str, n: int, minimum: int = 16, factor: int = 2) -> int:
    b = max(_bucket(n, minimum, factor), _HIGH_WATER.get(key, 0))
    _HIGH_WATER[key] = b
    return b


def reset_bucket_high_water():
    """Forget the per-process shape maxima (tests / bench isolation)."""
    _HIGH_WATER.clear()


#: serving-size bucket seeds for a full multi-camera run (the reference's
#: values: ~10-KF/50-anchor windows at 500-800 features per camera);
#: _hw_bucket still grows past them if a window is larger.
SERVING_BUCKETS = {
    "lba.K": 64, "lba.Em": 4096, "lba.Eg": 1024, "lba.Es": 16384,
    "lba.Ng": 64, "lba.Um": 256, "lba.Ug": 64, "lba.Sm": 256, "lba.Sg": 64,
    "lba.L": 4096, "lba.D": 128, "lba.De": 64,
    "pose.Nm": 1024, "pose.Ns": 1024,
}


def preset_shape_buckets(preset: "dict[str, int] | None" = None) -> None:
    """Seed the high-water shape buckets (default: SERVING_BUCKETS)."""
    for k, v in (preset or SERVING_BUCKETS).items():
        _HIGH_WATER[k] = max(_HIGH_WATER.get(k, 0), v)


def _pad(arr, n, fill=0):
    arr = np.asarray(arr)
    if arr.shape[0] >= n:
        return arr[:n]
    width = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, width, constant_values=fill)


def extract_local_ba(
    kf: KeyFrame,
    mp_table: dict,
    rig: Rig,
    max_opt: int = 10,
    max_fixed: int = 50,
    *,
    device,
    dtype=torch.float32,
    kf_table: dict | None = None,
):
    """Build a LocalGPBA window around `kf` (Optimizer.cc:713-1036 walk) on
    `device` in `dtype`.

    Returns (data: LocalBAData, state: BAState, handles) where handles maps
    solver array slots back to map entities for write-back. `kf_table`
    (Map.keyframes) makes fixed-anchor resolution O(1); without it the
    temporal chain is walked.

    The optimizable window is `Nd = min(#KF - 2, max_opt)` keyframes
    (Optimizer.cc:718-746): at least two keyframes always stay out of the
    window so the problem is gauge-anchored by a fixed prev-chain vertex.
    """
    # --- total keyframe count (for the Nd cap)
    if kf_table is not None:
        total = len(kf_table)
    else:
        total = 0
        k_ = kf
        while k_ is not None:
            total += 1
            k_ = k_.prev_kf
        k_ = kf.next_kf
        while k_ is not None:
            total += 1
            k_ = k_.next_kf
    nd = max(1, min(total - 2, max_opt))

    # --- temporal window via prev_kf chain
    window: list[KeyFrame] = [kf]
    while len(window) < nd and window[-1].prev_kf is not None:
        window.append(window[-1].prev_kf)
    window_ids = {k.id for k in window}

    # --- landmarks seen by the window
    lms: list = []
    lm_slot: dict[int, int] = {}
    for k in window:
        for mp_id in k.matches:
            if mp_id < 0 or int(mp_id) in lm_slot:
                continue
            mp = mp_table.get(int(mp_id))
            if mp is None or mp.bad:
                continue
            lm_slot[int(mp_id)] = len(lms)
            lms.append(mp)

    # --- fixed anchors: prev of the oldest window KF + covisible KFs
    fixed: list[KeyFrame] = []
    fixed_ids = set()
    tail_prev = window[-1].prev_kf
    if tail_prev is not None:
        fixed.append(tail_prev)
        fixed_ids.add(tail_prev.id)
    for mp in lms:
        for kf_id in mp.observations:
            if kf_id in window_ids or kf_id in fixed_ids:
                continue
            if kf_table is not None:
                other = kf_table.get(kf_id)
            else:
                other = _kf_by_id(window[0], kf_id)
            if other is not None and not other.bad:
                fixed.append(other)
                fixed_ids.add(kf_id)
            if len(fixed) >= max_fixed:
                break
        if len(fixed) >= max_fixed:
            break

    kfs = window + fixed  # index order: optimizable first
    n_opt = len(window)
    chain = list(reversed(window))
    if tail_prev is not None:
        chain = [tail_prev] + chain
    return _assemble_ba(kfs, n_opt, lms, lm_slot, chain, rig, device, dtype,
                        gp_huber=False)


def extract_global_ba(map_: Map, rig: Rig, *, device, dtype=torch.float32):
    """Build the full-map BA problem (GlobalBundleAdjustemnt ->
    BundleAdjustment, Optimizer.cc:53-367): every keyframe, only the origin
    fixed, GP chain over the whole temporal sequence with Huber delta
    (Optimizer.cc:130), all landmarks marginalized."""
    kfs_t = sorted(map_.keyframes.values(), key=lambda k: k.timestamp)
    if len(kfs_t) < 2:
        raise ValueError("global BA needs at least two keyframes")
    # optimizable-first slot order: origin (fixed) goes last
    kfs = kfs_t[1:] + [kfs_t[0]]
    n_opt = len(kfs) - 1
    lms, lm_slot = [], {}
    for k in kfs:
        for mp_id in k.matches:
            if mp_id < 0 or int(mp_id) in lm_slot:
                continue
            mp = map_.map_points.get(int(mp_id))
            if mp is None or mp.bad:
                continue
            lm_slot[int(mp_id)] = len(lms)
            lms.append(mp)
    return _assemble_ba(kfs, n_opt, lms, lm_slot, kfs_t, rig, device, dtype,
                        gp_huber=True)


def _keypoint_rows(f, g, rig):
    """`cam_of_global`, `keypoints[cam][local]` and `kp_inv_sigma2` of a
    Frame's or KeyFrame's global keypoint indices `g`, all at once: (camera,
    local index, uv (n,2) float64, information weight)."""
    cams = np.searchsorted(f.kp_offsets, g, side="right") - 1
    local = g - f.kp_offsets[cams]
    uv = np.concatenate([np.asarray(p, np.float64).reshape(-1, 2) for p in f.keypoints])[g]
    octv = np.concatenate([np.asarray(o).reshape(-1) for o in f.kp_octaves])[g]
    w = rig.inv_level_sigma2[octv.astype(np.int64)]
    sc = getattr(f, "kp_sigma2_scale", None)
    if sc is not None:  # the KB8 lift's variance inflation
        w = w / np.concatenate([
            np.ones(len(f.keypoints[c])) if sc[c] is None
            else np.asarray(sc[c], np.float64).reshape(-1)
            for c in range(len(f.keypoints))])[g]
    return cams, local, uv, w


def _close_flags(tcw_of, cams, X):
    """depth < CLOSE_DEPTH_TH of the float64 points X (n,3) in cameras
    `cams`, with `tcw_of(cam)` the camera's world-to-camera transform. The
    batched depth may differ from the per-point `(R @ x + t)[2]` in the last
    bits, so points within 1e-6 m of the threshold take the per-point form:
    the flags are the reference's."""
    depth = np.empty(len(cams))
    for c in np.unique(cams):
        sel = cams == c
        Tcw = tcw_of(int(c))
        depth[sel] = X[sel] @ Tcw[2, :3] + Tcw[2, 3]
    for n in np.nonzero(np.abs(depth - CLOSE_DEPTH_TH) < 1e-6)[0]:
        Tcw = tcw_of(int(cams[n]))
        depth[n] = (Tcw[:3, :3] @ X[n] + Tcw[:3, 3])[2]
    return depth < CLOSE_DEPTH_TH


def _assemble_ba(kfs, n_opt, lms, lm_slot, chain, rig, device, dtype, gp_huber):
    """Shared SoA assembly: kfs (optimizable-first), GP chain (temporal KF
    list), landmarks -> padded LocalBAData/BAState/handles."""
    kf_slot = {k.id: i for i, k in enumerate(kfs)}
    kf_map = {k.id: k for k in kfs}
    K_real = len(kfs)
    # phantom poses (fixed, no velocity edge, no GP chain, referenced by no
    # edge) pad the pose count to its bucket
    K = _hw_bucket("lba.K", K_real, minimum=4)

    # --- pose-level arrays
    times = np.array([k.timestamp for k in kfs])
    if K > K_real:
        times = np.concatenate([times, times[-1] + 1.0 + np.arange(K - K_real)])
    pose_fixed = (np.arange(K) >= n_opt) | (np.arange(K) >= K_real)
    vel_valid = ~pose_fixed

    gp_pairs = []
    for a, b in zip(chain[:-1], chain[1:]):
        gp_pairs.append((kf_slot[a.id], kf_slot[b.id]))
    gp_pairs = np.array(gp_pairs, np.int64).reshape(-1, 2)
    gp_dts = times[gp_pairs[:, 1]] - times[gp_pairs[:, 0]]
    gp_qi_inv = np.stack([rig.qi_inv(dt) for dt in gp_dts]) if len(gp_dts) else np.zeros((0, 12, 12))

    # --- observation edges (+ aligned erase-target metadata: the reference
    # erases mono-GP KF obs / GPObs records / stereo-cam obs differently,
    # Optimizer.cc:1257-1382). The keyframe edges are built one keyframe at
    # a time in arrays, in the reference's order (keyframes in slot order,
    # keypoints in global-index order); the GPObs edges follow them.
    sg, mg_gp, mg_gp_close = [], [], []
    mg_parts, st_parts, mg_close, st_close = [], [], [], []
    mg_meta, sg_meta, st_meta = [], [], []
    pos = np.stack([mp.position for mp in lms]) if lms else np.zeros((0, 3))
    pos64 = pos.astype(np.float64)
    lm_keys = np.fromiter(lm_slot, np.int64, len(lm_slot))
    order = np.argsort(lm_keys)
    lm_keys = lm_keys[order]
    lm_vals = np.fromiter(lm_slot.values(), np.int64, len(lm_slot))[order]
    stereo_cam = rig.n_cams - 1

    # one camera pose inverse per (keyframe, camera), not one per edge
    tcw = {}

    def _tcw(k, cam):
        Tcw = tcw.get((k.id, cam))
        if Tcw is None:
            Tcw = tcw[k.id, cam] = np.linalg.inv(k.Twb @ rig.Tbc[cam])
        return Tcw

    def _depth(k, cam, mp):
        Tcw = _tcw(k, cam)
        return float((Tcw[:3, :3] @ mp.position + Tcw[:3, 3])[2])

    for k in kfs:
        s = kf_slot[k.id]
        m = np.asarray(k.matches, np.int64)
        at = np.minimum(np.searchsorted(lm_keys, m), max(len(lm_keys) - 1, 0))
        hit = (m >= 0) & (lm_keys[at] == m) if len(lm_keys) else np.zeros(len(m), bool)
        g = np.nonzero(hit)[0]
        if not len(g):
            continue
        ls = lm_vals[at[g]]
        cams, local, uv, w = _keypoint_rows(k, g, rig)
        close = _close_flags(lambda c: _tcw(k, c), cams, pos64[ls])
        is_st = cams == stereo_cam
        if is_st.any():
            lo = local[is_st]
            ur = (np.asarray(k.kp_ur, np.float64)[lo] if k.kp_ur is not None
                  else np.full(len(lo), -1.0))
            st_parts.append(np.column_stack([
                np.full(len(lo), s), ls[is_st], uv[is_st], ur, w[is_st], ur >= 0]))
            st_close.append(close[is_st])
            st_meta.extend(zip([k] * len(lo), [lms[x] for x in ls[is_st].tolist()],
                               g[is_st].tolist()))
        # async cameras: GP edges on the (prev, this) pose pair
        if k.prev_kf is not None and k.prev_kf.id in kf_slot and not is_st.all():
            mo = ~is_st
            cm = cams[mo]
            mg_parts.append(np.column_stack([
                np.full(len(cm), kf_slot[k.prev_kf.id]), np.full(len(cm), s), ls[mo], cm,
                np.asarray(k.cam_times, np.float64)[cm], uv[mo], w[mo]]))
            mg_close.append(close[mo])
            mg_meta.extend(("kf", k, c, lms[x], gg) for c, x, gg in
                           zip(cm.tolist(), ls[mo].tolist(), g[mo].tolist()))
    # non-keyframe GPObs records attached to a KF's interval
    # (BundleAdjustment/LocalGPBA consume them against (KF, nextKF))
    for mp in lms:
        l = lm_slot[mp.id]  # noqa: E741
        for kf_id, obs in mp.gp_observations:
            if kf_id not in kf_slot:
                continue
            k = kf_map[kf_id]
            if k.next_kf is None or k.next_kf.id not in kf_slot:
                continue
            i, j = kf_slot[kf_id], kf_slot[k.next_kf.id]
            w = rig.inv_sigma2(obs.octave) / getattr(obs, "sigma2_scale", 1.0)
            if obs.cam == rig.n_cams - 1 and obs.ur >= 0:
                sg.append((i, j, l, obs.time, obs.uv[0], obs.uv[1], obs.ur, w))
                sg_meta.append(("gp", kf_id, obs, mp))
            else:
                mg_gp.append((i, j, l, obs.cam, obs.time, obs.uv[0], obs.uv[1], w))
                mg_gp_close.append(_depth(k, obs.cam, mp) < CLOSE_DEPTH_TH)
                mg_meta.append(("gp", kf_id, obs, mp))

    mg_a = np.concatenate(mg_parts + [np.array(mg_gp, np.float64).reshape(-1, 8)])
    st_a = np.concatenate(st_parts) if st_parts else np.zeros((0, 7))
    sg_a = np.array(sg) if sg else np.zeros((0, 8))
    mg_close = np.concatenate(mg_close + [np.array(mg_gp_close, bool)])
    st_close = np.concatenate(st_close) if st_close else np.zeros(0, bool)
    n_mg, n_sg, n_st = len(mg_a), len(sg), len(st_a)

    # edge/landmark dims grow x4 (the reference's coarse shape steps)
    Em = _hw_bucket("lba.Em", max(n_mg, 1), minimum=64, factor=4)
    Eg = _hw_bucket("lba.Eg", max(n_sg, 1), minimum=64, factor=4)
    Es = _hw_bucket("lba.Es", max(n_st, 1), minimum=64, factor=4)
    Ng = _hw_bucket("lba.Ng", max(len(gp_pairs), 1), minimum=4)

    Cx = rig.n_cams - 1
    mg_valid = _pad(np.ones(n_mg, bool), Em, False)
    sg_valid = _pad(np.ones(n_sg, bool), Eg, False)
    st_valid = _pad(np.ones(n_st, bool), Es, False)
    mg_pair = _pad(mg_a[:, :2], Em).astype(np.int32)
    mg_cam = _pad(mg_a[:, 3], Em).astype(np.int32)
    sg_pair = _pad(sg_a[:, :2], Eg).astype(np.int32)

    mg_sid, mg_sid_cols = make_structure_ids(
        _pad(mg_a[:, :2], Em), _pad(mg_a[:, 3], Em) if mg_a.size else np.zeros(Em),
        mg_valid, K, Cx,
    )
    sg_sid, sg_sid_cols = make_structure_ids(_pad(sg_a[:, :2], Eg), None, sg_valid, K, Cx)
    # structure counts are data-dependent; pad to high-water
    Sm = _hw_bucket("lba.Sm", len(mg_sid_cols), minimum=8)
    Sg = _hw_bucket("lba.Sg", len(sg_sid_cols), minimum=8)
    mg_sid_cols = _pad(mg_sid_cols, Sm)
    sg_sid_cols = _pad(sg_sid_cols, Sg)
    # interp-combo tables: the GP chain is evaluated once per unique
    # (structure, camera-timestamp) combo instead of once per edge
    mg_it, mg_it_sid, mg_it_t = build_interp_tables(
        mg_sid, _pad(mg_a[:, 4] if mg_a.size else np.zeros(0), Em), mg_valid)
    sg_it, sg_it_sid, sg_it_t = build_interp_tables(
        sg_sid, _pad(sg_a[:, 3] if sg_a.size else np.zeros(0), Eg), sg_valid)
    Um = _hw_bucket("lba.Um", len(mg_it_sid), minimum=16)
    Ug = _hw_bucket("lba.Ug", len(sg_it_sid), minimum=16)
    mg_it_sid, mg_it_t = _pad(mg_it_sid, Um), _pad(mg_it_t, Um)
    sg_it_sid, sg_it_t = _pad(sg_it_sid, Ug), _pad(sg_it_t, Ug)

    fields = dict(
        times=times,
        pose_fixed=pose_fixed,
        vel_valid=vel_valid,
        qcinv22=np.asarray(rig.qc_inv_diag[2], np.float64),
        gp_pairs=_pad(gp_pairs, Ng).astype(np.int32),
        gp_qi_inv=_pad(gp_qi_inv, Ng),
        gp_valid=_pad(np.ones(len(gp_pairs), bool), Ng, False),
        gp_huber=np.asarray(gp_huber),
        Tbc_stereo=rig.Tbc[-1],
        K_stereo=rig.K[-1],
        bf=np.asarray(rig.bf, np.float64),
        K_async=rig.K[:Cx],
        ext_fixed=np.ones(Cx, bool),
        R_prior=rig.Rbc_ini,
        ext_info=rig.ext_prior_info,
        mg_pair=mg_pair,
        mg_lm=_pad(mg_a[:, 2], Em).astype(np.int32),
        mg_cam=mg_cam,
        mg_t=_pad(mg_a[:, 4], Em),
        mg_obs=_pad(mg_a[:, 5:7], Em),
        mg_w=_pad(mg_a[:, 7] if mg_a.size else np.zeros(0), Em),
        mg_valid=mg_valid,
        mg_close=_pad(mg_close, Em, False),
        mg_sid=mg_sid,
        mg_sid_cols=mg_sid_cols,
        sg_pair=sg_pair,
        sg_lm=_pad(sg_a[:, 2], Eg).astype(np.int32),
        sg_t=_pad(sg_a[:, 3], Eg),
        sg_obs=_pad(sg_a[:, 4:7], Eg),
        sg_w=_pad(sg_a[:, 7] if sg_a.size else np.zeros(0), Eg),
        sg_valid=sg_valid,
        sg_sid=sg_sid,
        sg_sid_cols=sg_sid_cols,
        st_pose=_pad(st_a[:, 0], Es).astype(np.int32),
        st_lm=_pad(st_a[:, 1], Es).astype(np.int32),
        st_obs=_pad(st_a[:, 2:5], Es),
        st_w=_pad(st_a[:, 5] if st_a.size else np.zeros(0), Es),
        st_valid=st_valid,
        st_is_stereo=_pad(st_a[:, 6] if st_a.size else np.zeros(0), Es).astype(bool),
        st_close=_pad(st_close, Es, False),
        mg_it=mg_it,
        mg_it_sid=mg_it_sid,
        mg_it_t=mg_it_t,
        sg_it=sg_it,
        sg_it_sid=sg_it_sid,
        sg_it_t=sg_it_t,
    )

    # landmark-major gather tables; per-landmark slot depths are data
    # maxima, high-watered like the rest
    L = _hw_bucket("lba.L", max(len(lms), 1), minimum=64, factor=4)
    tabs = make_landmark_tables(
        fields["mg_lm"], mg_pair, mg_cam, mg_valid,
        fields["sg_lm"], sg_pair, sg_valid,
        fields["st_lm"], fields["st_pose"], st_valid,
        L, K, Cx,
        pad_d=_HIGH_WATER.get("lba.D", 0), pad_de=_HIGH_WATER.get("lba.De", 0),
    )
    fields.update(zip(("lm_blk", "lm_blk_g", "lm_blk_valid", "lm_edge", "lm_edge_valid"), tabs))
    _hw_bucket("lba.D", fields["lm_blk"].shape[1], minimum=4)
    _hw_bucket("lba.De", fields["lm_edge"].shape[1], minimum=4)
    X = _pad(pos, L)
    state_fields = dict(
        T=np.stack([k.Twb for k in kfs] + [np.eye(4)] * (K - K_real)),
        v=np.stack([k.velocity for k in kfs] + [np.zeros(6)] * (K - K_real)),
        Text=rig.Tbc[:Cx],
        X=X,
    )
    data, state = convert.ba_from_numpy(fields, state_fields, device=device, dtype=dtype)
    handles = {
        "kfs": kfs,
        "n_opt": n_opt,
        "lms": lms,
        "mg_refs": mg_a,   # (Em_real, 8) rows [i, j, lm, cam, t, u, v, w]
        "st_refs": st_a,   # (Es_real, 7) rows [pose, lm, u, v, ur, w, has_ur]
        "sg_refs": sg,
        "mg_meta": mg_meta,
        "st_meta": st_meta,
        "sg_meta": sg_meta,
    }
    return data, state, handles


def _kf_by_id(any_kf: KeyFrame, kf_id: int):
    """Resolve a keyframe id by walking the temporal chain both ways."""
    k = any_kf
    while k is not None:
        if k.id == kf_id:
            return k
        k = k.prev_kf
    k = any_kf
    while k is not None:
        if k.id == kf_id:
            return k
        k = k.next_kf
    return None


def _host_state(state):
    """(T, v, X) of a BAState as numpy arrays in the solve's dtype, as the
    reference's host copies are: one device-to-host read for tensors."""
    if isinstance(state.T, torch.Tensor):
        return convert.fetch(state.T, state.v, state.X, dtype=state.T.dtype)
    return state.T, state.v, state.X


def apply_local_ba(result_state, handles, mp_table: dict):
    """Write optimized poses/velocities/landmarks back (Optimizer.cc:1385-
    1428). `result_state` is a BAState of tensors or of host arrays."""
    T, v, X = _host_state(result_state)
    for i in range(handles["n_opt"]):
        kf = handles["kfs"][i]
        kf.set_pose(T[i])
        kf.velocity = v[i]
    for l, mp in enumerate(handles["lms"]):  # noqa: E741
        mp.position = X[l]


def apply_global_ba(result_state, handles, map_: Map):
    """Staged global-BA write-back (RunGlobalBundleAdjustment,
    LoopClosing.cc:1221-1339 mTbwGBA semantics): optimized poses/landmarks
    apply after convergence; keyframes created while GBA ran (absent from
    the problem) are corrected through their prev-chain parent's delta, and
    landmarks outside the problem through their reference keyframe's delta.
    """
    T, v, X = _host_state(result_state)
    in_problem = {}
    delta = {}  # kf_id -> Twb_after @ inv(Twb_before)
    for i, kf in enumerate(handles["kfs"]):
        in_problem[kf.id] = i
        delta[kf.id] = T[i] @ np.linalg.inv(kf.Twb)  # identity for the origin
    for i, kf in enumerate(handles["kfs"]):
        if i < handles["n_opt"]:
            kf.set_pose(T[i])
            kf.velocity = v[i]
    # propagate to keyframes created during GBA via the temporal chain
    for kf in sorted(map_.keyframes.values(), key=lambda k: k.timestamp):
        if kf.id in in_problem:
            continue
        parent = kf.prev_kf
        d = delta.get(parent.id) if parent is not None else None
        if d is None:
            d = np.eye(4)
        delta[kf.id] = d
        kf.set_pose(d @ kf.Twb)
    lm_in = set()
    for l, mp in enumerate(handles["lms"]):  # noqa: E741
        mp.position = X[l]
        lm_in.add(mp.id)
    for mp in map_.map_points.values():
        if mp.id in lm_in or mp.bad:
            continue
        d = delta.get(mp.first_kf_id)
        if d is not None:
            mp.position = d[:3, :3] @ mp.position + d[:3, 3]
    map_.increase_change_index()


def extract_pose_problem(
    frame: Frame,
    prev_frame: Frame,
    mp_table: dict,
    rig: Rig,
    fix_prev: bool = True,
    *,
    device,
    dtype=torch.float32,
):
    """Build the per-frame PoseGPData (Optimizer::PoseGPOptimizationFromeLastFrame
    walk, Optimizer.cc:418-546) on `device` in `dtype`. Returns (data, state,
    handles)."""
    m = np.asarray(frame.matches, np.int64)
    g = np.nonzero(m >= 0)[0]
    mps = [mp_table.get(i) for i in m[g].tolist()]
    keep = np.array([mp is not None and not mp.bad for mp in mps], bool)
    g = g[keep]
    X = np.array([mp.position for mp, k in zip(mps, keep) if k], np.float64).reshape(-1, 3)
    Tcws = [np.linalg.inv(frame.Twb @ Tbc) for Tbc in rig.Tbc]
    cams, local, uv, w = _keypoint_rows(frame, g, rig)
    close = _close_flags(lambda c: Tcws[c], cams, X)
    is_st = cams == rig.n_cams - 1
    mo = ~is_st
    mg_a = np.column_stack([X[mo], np.asarray(frame.cam_times, np.float64)[cams[mo]],
                            cams[mo], uv[mo], w[mo], close[mo]]).reshape(-1, 9)
    lo = local[is_st]
    ur = (np.asarray(frame.kp_ur, np.float64)[lo] if frame.kp_ur is not None
          else np.full(len(lo), -1.0))
    st_a = np.column_stack([X[is_st], uv[is_st], ur, w[is_st], ur >= 0,
                            close[is_st]]).reshape(-1, 9)
    mg_idx, st_idx = g[mo], g[is_st]
    n_mg, n_st = len(mg_a), len(st_a)

    Nm = _hw_bucket("pose.Nm", max(n_mg, 1), minimum=64, factor=4)
    Ns = _hw_bucket("pose.Ns", max(n_st, 1), minimum=64, factor=4)

    dt = frame.timestamp - prev_frame.timestamp
    fields = dict(
        t_prev=np.asarray(prev_frame.timestamp, np.float64),
        t_cur=np.asarray(frame.timestamp, np.float64),
        qi_inv=rig.qi_inv(dt),
        qcinv22=np.asarray(rig.qc_inv_diag[2], np.float64),
        fix_prev=np.asarray(fix_prev),
        Tbc=rig.Tbc,
        K=rig.K,
        bf=np.asarray(rig.bf, np.float64),
        mg_obs=_pad(mg_a[:, 5:7], Nm),
        mg_Xw=_pad(mg_a[:, 0:3], Nm),
        mg_t=_pad(mg_a[:, 3], Nm),
        mg_cam=_pad(mg_a[:, 4], Nm).astype(np.int32),
        mg_w=_pad(mg_a[:, 7] if mg_a.size else np.zeros(0), Nm),
        mg_valid=_pad(np.ones(n_mg, bool), Nm, False),
        mg_close=_pad(mg_a[:, 8] if mg_a.size else np.zeros(0), Nm).astype(bool),
        st_obs=_pad(st_a[:, 3:6], Ns),
        st_Xw=_pad(st_a[:, 0:3], Ns),
        st_w=_pad(st_a[:, 6] if st_a.size else np.zeros(0), Ns),
        st_valid=_pad(np.ones(n_st, bool), Ns, False),
        st_is_stereo=_pad(st_a[:, 7] if st_a.size else np.zeros(0), Ns).astype(bool),
        st_close=_pad(st_a[:, 8] if st_a.size else np.zeros(0), Ns).astype(bool),
        # every async camera fires once per frame: its features all share
        # cam_times[cam], so the interp table is the camera-time array
        # (U = n_cams rows) and mg_it is the edge's camera index
        mg_it=_pad(mg_a[:, 4] if mg_a.size else np.zeros(0), Nm).astype(np.int32),
        it_t=np.asarray(frame.cam_times, np.float64),
    )
    state_fields = dict(T=np.stack([prev_frame.Twb, frame.Twb]),
                        v=np.stack([prev_frame.velocity, frame.velocity]))
    data, state = convert.pose_from_numpy(fields, state_fields, device=device, dtype=dtype)
    handles = {"mg_idx": mg_idx, "st_idx": st_idx,
               "Nm": Nm, "Ns": Ns, "n_mg": n_mg, "n_st": n_st}
    return data, state, handles
