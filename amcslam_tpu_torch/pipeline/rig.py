"""Multi-camera rig + GP-prior configuration (the Tracking-side config state).

A copy of `amcslam_tpu/pipeline/rig.py`.

Bundles what the reference scatters across static MultiFrame/MultiKeyFrame
members and the Tracking parse methods (Tracking.cc:604-991): per-camera
extrinsics Tbc (`sensor_to_vehicle`), intrinsics (per-camera JSON
`intrinsics`), the stereo bf, ORB pyramid sigma levels, and the GP
power-spectral density Qc (`Gaussian.Qc` diag + initial velocity).
Convention: cameras 0..C-2 are async monos, camera C-1 is the stereo pair
(orb_multicam.yaml:3-14).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Rig:
    Tbc: np.ndarray                 # (C,4,4) camera-to-body
    K: np.ndarray                   # (C,4) fx, fy, cx, cy
    bf: float                       # stereo baseline * fx
    qc_diag: np.ndarray = field(default_factory=lambda: np.ones(6))
    ini_vel: np.ndarray = field(default_factory=lambda: np.zeros(6))
    scale_factor: float = 1.2
    n_levels: int = 8
    cam_time_offsets: np.ndarray | None = None  # (C,) per-camera offset vs stereo
    dist: np.ndarray | None = None  # (C,5) radial-tangential k1 k2 p1 p2 k3
    # online extrinsic refinement (LocalGPBA phase 2): rotation-prior
    # information. The reference names the matrix a covariance
    # (mRbc_ini_cov = 0.2*I, Frame.cc:182) but passes it DIRECTLY to
    # setInformation (Optimizer.cc:992) — so information = 0.2*I is the
    # reference behavior, reproduced here verbatim (not inverted).
    # Also the per-camera observation count needed to unfix an extrinsic
    # (extrin_thresh = 50, Optimizer.cc:1227)
    ext_prior_info: np.ndarray | None = None  # (Cx,3,3)
    ext_min_obs: int = 50
    # per-camera model tags (Settings.h:46-50 camera-type enum): None means
    # all-pinhole; entries equal to cameras.CAMERA_KB8 mark fisheye cameras
    # whose keypoints are lifted to the rectified-pinhole plane at frame
    # build (cameras.rectify_kb8_points). kb8_params rows are
    # [fx fy cx cy k1 k2 k3 k4]; K[c] must equal kb8_params[c,:4].
    cam_model: np.ndarray | None = None  # (C,) int
    kb8_params: np.ndarray | None = None  # (C,8)

    def __post_init__(self):
        self.qc_inv_diag = 1.0 / self.qc_diag
        # extrinsic rotation priors anchor at the CALIBRATED rotations
        # (mRbc_ini, Frame.cc:164-182): capture before refinement mutates Tbc
        self.Rbc_ini = np.array(self.Tbc[: len(self.K) - 1, :3, :3], copy=True)
        if self.ext_prior_info is None:
            self.ext_prior_info = np.tile(
                np.eye(3) * 0.2, (max(len(self.K) - 1, 1), 1, 1)
            )
        factors = self.scale_factor ** np.arange(self.n_levels)
        self.level_sigma2 = factors**2
        self.inv_level_sigma2 = 1.0 / self.level_sigma2
        if self.cam_time_offsets is None:
            # async cameras staggered uniformly inside the stereo frame period
            C = len(self.K)
            self.cam_time_offsets = np.concatenate(
                [-np.linspace(0.02, 0.08, max(C - 1, 1)), [0.0]]
            )[:C]

    @property
    def n_cams(self) -> int:
        return len(self.K)

    def inv_sigma2(self, octave: int) -> float:
        return float(self.inv_level_sigma2[int(octave)])

    def qi_inv(self, dt: float) -> np.ndarray:
        """12x12 GP prior information over an interval (GaussianProcess.h:34-45)."""
        Q = np.zeros((12, 12))
        Q[:6, :6] = np.diag(12.0 / dt**3 * self.qc_inv_diag)
        Q[:6, 6:] = np.diag(-6.0 / dt**2 * self.qc_inv_diag)
        Q[6:, :6] = np.diag(-6.0 / dt**2 * self.qc_inv_diag)
        Q[6:, 6:] = np.diag(4.0 / dt * self.qc_inv_diag)
        return Q

    def cam_times(self, stereo_time: float) -> np.ndarray:
        return stereo_time + self.cam_time_offsets
