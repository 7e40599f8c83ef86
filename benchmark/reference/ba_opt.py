"""How far a bundle adjustment's answer lies from the optimum of its own
problem, in numpy float64.

`gauss_newton` linearises the robust cost of `ba_cost` at a state as g2o
does (each observation's Huber weight taken at the state, its second
derivative left out) and returns the cost that one Gauss-Newton step would
remove, g^T H^-1 g with g = J^T W r and H = J^T W J, beside the cost
itself, and the step. `optimality_gap` is their ratio: at an optimum it
sits at the rounding of the solver's precision; an answer the solve did not
reach (a state returned unchanged, iterations cut short) or altered after
reads orders of magnitude higher.

The free variables are each pose's 12 (T <- T exp(d) and v <- v + dv) where
"pose_fixed" (or "n_fixed") leaves them free, and every landmark that an
observation reaches; the extrinsics are held, as the local BA holds them.
Derivatives are central differences of the definitions in `ba_cost`,
taken where they are cheap: an observation depends on its landmark and on
the body pose its keyframe pair interpolates at its time, so the
derivatives of the interpolated pose by the pair's 24 variables are taken
once per (pair, time), those of the pixels by that pose and by the
landmark once per observation. The landmarks are eliminated by their 3x3
blocks (the Schur complement), the pose system is solved dense.

Every observation weighs 1, as in `ba_cost`.
"""

from __future__ import annotations

import numpy as np

from . import lie
from .ba_cost import DELTA2_MONO, DELTA2_STEREO, DELTA_GP, _rows, cost, gp_pose

H = 1e-6  # central-difference step (rad, m, m/s)


def _basis(n):
    e = np.zeros((2 * n, n))
    e[0::2] = np.eye(n) * H
    e[1::2] = -np.eye(n) * H
    return e


def _huber_sqrt_w(s, delta2):
    """sqrt of g2o's Huber weight rho'(s): 1 inside, (delta / sqrt(s))^(1/2) outside."""
    return np.sqrt(np.where(s <= delta2, 1.0, np.sqrt(delta2) / np.sqrt(np.maximum(s, 1e-300))))


def _pair_derivs(fn, T, v, a, b):
    """fn(Ta, va, Tb, vb) -> (U, m) residual-like values per pair, and their
    central differences (U, m, 24) by the pair's 24 variables (a's T, a's v,
    b's T, b's v)."""
    cols = []
    for q in range(24):
        out = []
        for sign in (1.0, -1.0):
            Ta, va, Tb, vb = T[a].copy(), v[a].copy(), T[b].copy(), v[b].copy()
            d = np.zeros(6)
            d[q % 6] = sign * H
            if q < 6:
                Ta = Ta @ lie.exp_se3(d)
            elif q < 12:
                va = va + d
            elif q < 18:
                Tb = Tb @ lie.exp_se3(d)
            else:
                vb = vb + d
            out.append(fn(Ta, va, Tb, vb))
        cols.append((out[0] - out[1]) / (2 * H))
    return np.stack(cols, -1)


def _sum_by(index, values, n):
    """values (N, ...) summed by index (N,) into (n, ...)."""
    flat = values.reshape(len(values), -1)
    out = np.stack([np.bincount(index, flat[:, k], n) for k in range(flat.shape[1])], 1)
    return out.reshape((n,) + values.shape[1:])


def _project(K, Y, bf):
    u = K[..., 0] * Y[..., 0] / Y[..., 2] + K[..., 2]
    v = K[..., 1] * Y[..., 1] / Y[..., 2] + K[..., 3]
    return np.stack([u, v, u - bf / Y[..., 2]], -1)


class _System:
    """The normal equations, poses dense (12 K), landmarks by 3x3 blocks."""

    def __init__(self, K, L):
        self.Hpp = np.zeros((12 * K, 12 * K))
        self.gp = np.zeros(12 * K)
        self.Hpl = np.zeros((12 * K, L, 3))
        self.Hll = np.zeros((L, 3, 3))
        self.gl = np.zeros((L, 3))

    def add_pose_rows(self, vidx, J, r):
        """Rows r (U, m) with derivatives J (U, m, 24) by variables vidx (U, 24)."""
        np.add.at(self.Hpp, (vidx[:, :, None], vidx[:, None, :]),
                  np.einsum("umi,umj->uij", J, J))
        np.add.at(self.gp, vidx, np.einsum("umi,um->ui", J, r))

    def add_observations(self, vidx, D, combo, lm, Jeps, Jx, r):
        """Observation rows r (N, 3) with derivatives Jeps (N, 3, 6) by the
        interpolated pose and Jx (N, 3, 3) by the landmark; D (U, 6, 24) the
        interpolated pose's derivatives by its pair's variables."""
        U, L = len(D), len(self.gl)
        JeT = Jeps.transpose(0, 2, 1)
        A = _sum_by(combo, JeT @ Jeps, U)
        ge = _sum_by(combo, (JeT @ r[:, :, None])[..., 0], U)
        DT = D.transpose(0, 2, 1)
        np.add.at(self.Hpp, (vidx[:, :, None], vidx[:, None, :]), DT @ A @ D)
        np.add.at(self.gp, vidx, (DT @ ge[:, :, None])[..., 0])
        cross = DT[combo] @ (JeT @ Jx)                                    # (N,24,3)
        flat = (vidx[combo][:, :, None] * L + lm[:, None, None]) * 3 + np.arange(3)
        self.Hpl += np.bincount(flat.ravel(), cross.ravel(), self.Hpl.size).reshape(self.Hpl.shape)
        JxT = Jx.transpose(0, 2, 1)
        self.Hll += _sum_by(lm, JxT @ Jx, L)
        self.gl += _sum_by(lm, (JxT @ r[:, :, None])[..., 0], L)

    def solve(self, free):
        """(the decrease g^T H^-1 g, the pose step (12 K,), the landmark step
        (L, 3)) over the free pose variables and the observed landmarks."""
        seen = np.abs(self.Hll).sum((1, 2)) > 0
        Hll_inv = np.zeros_like(self.Hll)
        if seen.any():
            Hll_inv[seen] = np.linalg.pinv(self.Hll[seen], rcond=1e-12, hermitian=True)
        y = np.einsum("lij,lj->li", Hll_inv, self.gl)
        HplW = np.einsum("plj,lji->pli", self.Hpl, Hll_inv)
        n = len(self.gp)
        S = self.Hpp - HplW.reshape(n, -1) @ self.Hpl.reshape(n, -1).T
        b = self.gp - np.einsum("pli,li->p", self.Hpl, y)
        f = np.nonzero(free)[0]
        dp = np.zeros_like(self.gp)
        if f.size:
            dp[f] = np.linalg.lstsq(S[np.ix_(f, f)], b[f], rcond=None)[0]
        dl = y - np.einsum("lij,lj->li", Hll_inv, np.einsum("pli,p->li", self.Hpl, dp))
        return float(self.gl.ravel() @ y.ravel() + b[f] @ dp[f]), -dp, -dl


def gauss_newton(p: dict, rig: dict, state: dict, gp_huber: bool):
    """(the cost that one Gauss-Newton step from `state` would remove, the
    cost at `state`, the state after that step). `p`, `rig`, `state` as in
    `ba_cost.parts`."""
    Tbc, Kc, bf = rig["Tbc"], np.asarray(rig["K"], np.float64), float(rig["bf"])
    qc = np.asarray(rig["qc"], np.float64)
    T, v, Text, X = (np.asarray(state[k], np.float64) for k in ("T", "v", "Text", "X"))
    times = np.asarray(p["times"], np.float64)
    nK, L = len(T), len(X)
    cams = np.concatenate([Text, Tbc[-1:]], 0)
    sysm = _System(nK, L)

    # the observation sets as (pair i, pair j, time, camera, landmark, obs (N,3),
    # right row used, delta^2), a keyframe observation as the pair (k, k)
    sets = []
    e = _rows(p, "mg", len(p["mg_lm"]))
    if e.size:
        obs = np.zeros((e.size, 3))
        obs[:, :2] = np.asarray(p["mg_obs"], np.float64)[e]
        sets.append((p["mg_pair"][e, 0], p["mg_pair"][e, 1], np.asarray(p["mg_t"], np.float64)[e],
                     p["mg_cam"][e], p["mg_lm"][e], obs, np.zeros(e.size, bool),
                     np.full(e.size, DELTA2_MONO)))
    e = _rows(p, "st", len(p["st_lm"]))
    if e.size:
        k = p["st_pose"][e]
        st = np.asarray(p["st_is_stereo"], bool)[e]
        sets.append((k, k, times[k], np.full(e.size, len(cams) - 1), p["st_lm"][e],
                     np.asarray(p["st_obs"], np.float64)[e], st,
                     np.where(st, DELTA2_STEREO, DELTA2_MONO)))
    if "sg_lm" in p and len(p["sg_lm"]):
        e = _rows(p, "sg", len(p["sg_lm"]))
        if e.size:
            sets.append((p["sg_pair"][e, 0], p["sg_pair"][e, 1],
                         np.asarray(p["sg_t"], np.float64)[e], np.full(e.size, len(cams) - 1),
                         p["sg_lm"][e], np.asarray(p["sg_obs"], np.float64)[e],
                         np.ones(e.size, bool), np.full(e.size, DELTA2_STEREO)))

    for i, j, t, c, lm, obs, right, delta2 in sets:
        key = np.stack([i, j, t], 1)
        uniq, combo = np.unique(key, axis=0, return_inverse=True)
        combo = combo.ravel()
        ci, cj, ct = uniq[:, 0].astype(np.int64), uniq[:, 1].astype(np.int64), uniq[:, 2]
        at_kf = ci == cj
        ti, tj = times[ci], times[cj]

        def interp(Ta, va, Tb, vb):
            Tt = np.where(at_kf[:, None, None], Ta, 0.0)
            g = ~at_kf
            if g.any():
                Tt[g] = gp_pose(Ta[g], va[g], ti[g], Tb[g], vb[g], tj[g], ct[g])
            return Tt

        Tt = interp(T[ci], v[ci], T[cj], v[cj])
        Tt_inv = lie.rigid_inv(Tt)
        D = _pair_derivs(lambda *s: lie.log_se3(Tt_inv @ interp(*s)), T, v, ci, cj)  # (U,6,24)
        # a keyframe observation moves its one pose once, not as both ends
        D[at_kf, :, 12:] = 0.0
        vidx = np.concatenate([12 * ci[:, None] + np.arange(12), 12 * cj[:, None] + np.arange(12)], 1)

        # body-frame points, camera transforms, and the pixels' derivatives by
        # the interpolated pose (Tt exp(eps)) and by the landmark
        Tcb = lie.rigid_inv(cams[c])
        Rt, tt = Tt_inv[combo, :3, :3], Tt_inv[combo, :3, 3]
        P = np.einsum("nij,nj->ni", Rt, X[lm]) + tt

        def pixels(Pb):
            Y = np.einsum("nij,...nj->...ni", Tcb[:, :3, :3], Pb) + Tcb[:, :3, 3]
            return _project(Kc[c], Y, bf)

        r = obs - pixels(P)
        Meps = lie.exp_se3(-_basis(6))              # exp(-eps): (12,4,4)
        Pe = np.einsum("kij,nj->kni", Meps[:, :3, :3], P) + Meps[:, None, :3, 3]
        pe = pixels(Pe)
        Jeps = -(pe[0::2] - pe[1::2]).transpose(1, 2, 0) / (2 * H)      # (N,3,6)
        Px = P[None] + np.einsum("nij,kj->kni", Rt, _basis(3))
        px = pixels(Px)
        Jx = -(px[0::2] - px[1::2]).transpose(1, 2, 0) / (2 * H)        # (N,3,3)
        r[~right, 2] = 0.0
        Jeps[~right, 2] = 0.0
        Jx[~right, 2] = 0.0
        w = _huber_sqrt_w((r * r).sum(1), delta2)
        sysm.add_observations(vidx, D, combo, lm, Jeps * w[:, None, None],
                              Jx * w[:, None, None], r * w[:, None])

    # the GP prior, whitened by the Cholesky factor of its information
    if "gp_pairs" in p:
        g = _rows(p, "gp", len(p["gp_pairs"]))
        a, b = p["gp_pairs"][g, 0], p["gp_pairs"][g, 1]
    else:
        a, b = np.arange(nK - 1), np.arange(1, nK)
    if a.size:
        dt = times[b] - times[a]
        q = np.diag(1.0 / qc)
        Qinv = np.stack([np.block([[12.0 / d ** 3 * q, -6.0 / d ** 2 * q],
                                   [-6.0 / d ** 2 * q, 4.0 / d * q]]) for d in dt])
        Lc = np.linalg.cholesky(Qinv)

        def prior(Ta, va, Tb, vb):
            xi = lie.log_se3(lie.rigid_inv(Ta) @ Tb)
            rr = np.concatenate([xi - dt[:, None] * va,
                                 (lie.right_jacobian_inv(xi) @ vb[..., None])[..., 0] - va], -1)
            return np.einsum("ui,uij->uj", rr, Lc)

        rg = prior(T[a], v[a], T[b], v[b])
        Jg = _pair_derivs(prior, T, v, a, b)
        w = (_huber_sqrt_w((rg * rg).sum(1), DELTA_GP ** 2) if gp_huber
             else np.ones(len(rg)))
        vidx = np.concatenate([12 * a[:, None] + np.arange(12), 12 * b[:, None] + np.arange(12)], 1)
        sysm.add_pose_rows(vidx, Jg * w[:, None, None], rg * w[:, None])

    # the lateral velocity prior on the free keyframes
    fixed = (np.asarray(p["pose_fixed"], bool) if "pose_fixed" in p
             else np.arange(nK) < int(p["n_fixed"]))
    vel = (np.asarray(p["vel_valid"], bool) if "vel_valid" in p else ~fixed)
    kv = np.nonzero(vel)[0]
    if kv.size:
        sysm.add_pose_rows(12 * kv[:, None] + np.array([[8]]),
                           np.ones((kv.size, 1, 1)) / np.sqrt(qc[2]),
                           (v[kv, 2] / np.sqrt(qc[2]))[:, None])

    free = np.repeat(~fixed, 12)
    decrease, dp, dl = sysm.solve(free)
    dp = dp.reshape(nK, 12)
    after = {"T": T @ lie.exp_se3(dp[:, :6]), "v": v + dp[:, 6:], "Text": Text, "X": X + dl}
    return decrease, cost(p, rig, state, gp_huber), after


def optimality_gap(p: dict, rig: dict, state: dict, gp_huber: bool) -> float:
    decrease, total, _ = gauss_newton(p, rig, state, gp_huber)
    return decrease / total
