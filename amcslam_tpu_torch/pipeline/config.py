"""Configuration loading (rebuild of Settings.cc + the Tracking parse methods).

Port of `amcslam_tpu/pipeline/config.py`: the run YAML (Camera.number,
dataset path, Gaussian.Qc diag, Velocity prior, Ransac.threshold, ORB
params, Extrinsic, loopClosing, thFarPoints — orb_multicam.yaml:1-33) and
per-camera JSON calibration files (`sensor_to_vehicle` 4x4 -> Tbc,
`intrinsics` 3x3 -> K; Tracking.cc:681-734) -> a Rig + TrackingConfig +
system flags, with the reference's keys and defaults.

The reference reads the YAML with PyYAML; the port reads the flat subset
those keys use with its own reader (`parse_flat_yaml`), which raises on
anything outside it instead of guessing.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass

import numpy as np

from .rig import Rig
from .tracking import TrackingConfig

# YAML 1.1 scalar resolution as PyYAML's safe loader does it
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**dict.fromkeys("yes Yes YES true True TRUE on On ON".split(), True),
         **dict.fromkeys("no No NO false False FALSE off Off OFF".split(), False)}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_INT_HEX = re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")
_INT_OCT = re.compile(r"^[-+]?0[0-7_]+$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")


def _plain_scalar(s: str, where: str):
    if s[:1] in "&*!|>@`{%":
        raise ValueError(f"{where}: unsupported YAML construct {s!r}")
    if _NULL.match(s):
        return None
    if s in _BOOL:
        return _BOOL[s]
    sign = -1 if s.startswith("-") else 1
    digits = s.lstrip("+-").replace("_", "")
    if _INT.match(s):
        return sign * int(digits)
    if _INT_HEX.match(s):
        return sign * int(digits, 16)
    if _INT_OCT.match(s):
        return sign * int(digits, 8)
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return sign * float("inf")
    if _NAN.match(s):
        return float("nan")
    return s


def _quoted(text: str, i: int, where: str):
    """The quoted string starting at text[i] -> (value, index after it)."""
    q = text[i]
    out, j = [], i + 1
    while j < len(text):
        ch = text[j]
        if q == "'" and ch == "'":
            if text[j + 1: j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            esc = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}
            if text[j + 1: j + 2] not in esc:
                raise ValueError(f"{where}: unsupported escape in {text[i:]!r}")
            out.append(esc[text[j + 1]])
            j += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise ValueError(f"{where}: unterminated quoted string {text[i:]!r}")


def _strip_comment(text: str) -> str:
    """`text` up to a comment: a `#` at its start or after a blank, outside
    quotes."""
    quote = None
    for j, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (j == 0 or text[j - 1] in " \t[,"):
            quote = ch
        elif ch == "#" and (j == 0 or text[j - 1] in " \t"):
            return text[:j]
    return text


def _value(text: str, where: str):
    """A scalar or a one-line flow list of scalars."""
    text = text.strip()
    if text[:1] in "'\"":
        val, end = _quoted(text, 0, where)
        if text[end:].strip():
            raise ValueError(f"{where}: text after a quoted value: {text!r}")
        return val
    if not text.startswith("["):
        return _plain_scalar(text, where)
    if not text.endswith("]"):
        raise ValueError(f"{where}: a flow list must close on its line: {text!r}")
    body = text[1:-1]
    if not body.strip():
        return []
    items, i = [], 0
    while True:
        i = len(body) - len(body[i:].lstrip())
        if body[i] in "'\"":
            val, i = _quoted(body, i, where)
        else:
            end = body.find(",", i)
            end = len(body) if end < 0 else end
            item = body[i:end].strip()
            if not item or item[0] in "[{":
                raise ValueError(f"{where}: unsupported flow list {text!r}")
            val, i = _plain_scalar(item, where), end
        items.append(val)
        rest = body[i:].lstrip()
        if not rest:
            return items
        if rest[0] != ",":
            raise ValueError(f"{where}: expected `,` in {text!r}")
        i = len(body) - len(rest) + 1


def parse_flat_yaml(text: str, source: str = "<yaml>") -> dict:
    """The flat OpenCV-YAML subset of a run config -> dict: an optional
    `%YAML:1.0` header and `---` marker, `key: scalar`, `key: [flow, list]`
    of scalars, plain or quoted strings and `#` comments, scalars typed as
    PyYAML's safe loader types them (ints, floats with a dot, booleans,
    null). Anything else (indentation, block sequences or mappings, flow
    mappings, anchors, tags, multi-line values) raises ValueError."""
    out = {}
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if n == 1 and line.startswith("%YAML"):
            if line not in ("%YAML:1.0", "%YAML 1.0", "%YAML:1.1", "%YAML 1.1"):
                raise ValueError(f"{where}: unsupported directive {line!r}")
            continue
        if line == "---" and not out:
            continue
        if line[0] in " \t" or line.startswith(("- ", "? ")) or line in ("-", "...", "---"):
            raise ValueError(f"{where}: only flat `key: value` lines are supported: {raw!r}")
        m = re.match(r"^([^\s:'\"#\[\]{},&*!|>%@`][^:]*?):(?:[ \t]+(.*))?$", line)
        if m is None:
            raise ValueError(f"{where}: not a `key: value` line: {raw!r}")
        key, val = m.group(1), m.group(2) or ""
        if not val.strip():
            raise ValueError(f"{where}: a key without a value on its line opens a block: {raw!r}")
        out[key] = _value(val, where)
    return out


@dataclass
class SystemConfig:
    rig: Rig
    tracking: TrackingConfig
    loop_closing: bool = True
    extrinsic_refine: bool = False
    dataset_path: str = ""
    n_features: int = 1200
    th_far_points: float = 0.0


def load_camera_json(path: str):
    """Per-camera JSON: sensor_to_vehicle (Tbc), intrinsics (K)."""
    with open(path) as f:
        d = json.load(f)
    Tbc = np.asarray(d["sensor_to_vehicle"], float).reshape(4, 4)
    Km = np.asarray(d["intrinsics"], float).reshape(3, 3)
    K4 = np.array([Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]])
    return Tbc, K4


def load_config(yaml_path: str) -> SystemConfig:
    with open(yaml_path) as f:
        cfg = parse_flat_yaml(f.read(), yaml_path)

    n_cams = int(cfg.get("Camera.number", 2))
    base = os.path.dirname(os.path.abspath(yaml_path))

    Tbcs, Ks = [], []
    cam_files = cfg.get("Camera.calibfiles", [])
    if cam_files:
        for cf in cam_files:
            Tbc, K4 = load_camera_json(os.path.join(base, cf))
            Tbcs.append(Tbc)
            Ks.append(K4)
    else:
        # flat-key fallback: Camera.fx etc. for a single-model rig
        fx = float(cfg.get("Camera.fx", 420.0))
        fy = float(cfg.get("Camera.fy", fx))
        cx = float(cfg.get("Camera.cx", 480.0))
        cy = float(cfg.get("Camera.cy", 300.0))
        for _ in range(n_cams):
            Tbcs.append(np.eye(4))
            Ks.append(np.array([fx, fy, cx, cy]))

    qc = cfg.get("Gaussian.Qc", [1.0] * 6)
    if np.isscalar(qc):
        qc = [float(qc)] * 6
    ini_vel = np.asarray(cfg.get("Velocity", [0.0] * 6), float)

    rig = Rig(
        Tbc=np.stack(Tbcs),
        K=np.stack(Ks),
        bf=float(cfg.get("Camera.bf", 40.0)),
        qc_diag=np.asarray(qc, float),
        ini_vel=ini_vel,
        scale_factor=float(cfg.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(cfg.get("ORBextractor.nLevels", 8)),
    )
    tracking = TrackingConfig(ransac_threshold=float(cfg.get("Ransac.threshold", 3.0)))
    return SystemConfig(
        rig=rig,
        tracking=tracking,
        loop_closing=bool(cfg.get("loopClosing", 1)),
        extrinsic_refine=bool(cfg.get("Extrinsic", 0)),
        dataset_path=str(cfg.get("dataset", "")),
        n_features=int(cfg.get("ORBextractor.nFeatures", 1200)),
        th_far_points=float(cfg.get("thFarPoints", 0.0)),
    )
