"""Track-level filters, replicating the reference data gates.

Behavioral parity targets (files of the reference code base):
- ``check_data_sanity``        — modify_scripts/ablation.py:55-68
- ``filter_context``           — scripts/train.py:44-65
- ``parse_lane_from_context``  — scripts/train.py:67-76
- ``get_polygon_from_lane_roi``— scripts/train.py:78-87
- ``is_trajectory_abnormal``   — scripts/train.py:89-108

These are host-side, NumPy-only functions: they run once at dataset build
time and produce fixed-shape arrays, so nothing here ever traces under jit.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

_LANE_REJECT_RE = re.compile(r"^\s*A[4-6]\s*:")
_LANE_KEEP_RE = re.compile(r"^\s*A[1-3]\s*:")
_LANE_PARSE_RE = re.compile(r"lane\s+(A[1-3]|safe)")


def check_data_sanity(tracks: List[dict], max_abs_coord: float = 1e6) -> List[dict]:
    """Drop tracks with missing/NaN/Inf trajectories or extreme coordinates."""
    clean = []
    for item in tracks:
        traj = item.get("raw_trajectory")
        if traj is None:
            continue
        traj = np.asarray(traj, dtype=np.float64)
        if traj.ndim != 2 or traj.shape[-1] != 2 or traj.shape[0] == 0:
            continue
        if not np.all(np.isfinite(traj)):
            continue
        if np.any(np.abs(traj) > max_abs_coord):
            continue
        clean.append(item)
    return clean


def filter_context(context: str) -> Tuple[Optional[str], Optional[str]]:
    """Keep only A1-A3 lines; reject tracks mentioning lanes A4-A6.

    Returns (filtered_context, direction) where direction is "L2R"/"R2L"
    (default R2L), or (None, None) if the track must be dropped.
    """
    if not context.strip():
        return "No context provided", "R2L"
    filtered_lines = []
    for line in context.splitlines():
        if _LANE_REJECT_RE.match(line):
            return None, None
        if _LANE_KEEP_RE.match(line):
            filtered_lines.append(line)
    if not filtered_lines:
        return "No valid context lines", "R2L"
    filtered_ctx = "\n".join(filtered_lines).strip()
    ctx_lower = context.lower()
    if "left to right" in ctx_lower:
        direction = "L2R"
    elif "right to left" in ctx_lower:
        direction = "R2L"
    else:
        direction = "R2L"
    return filtered_ctx, direction


def parse_lane_from_context(context_str: str) -> Optional[str]:
    """Extract the ego lane key: "1"/"2"/"3" or "safe"."""
    m = _LANE_PARSE_RE.search(context_str)
    if not m:
        return None
    lane = m.group(1)
    return "safe" if lane == "safe" else lane[1:]


def get_polygon_from_lane_roi(lane_roi: Optional[dict], lane_str: Optional[str],
                              site: str = "Site C", zone: str = "A") -> np.ndarray:
    """Look up the (N,2) float32 polygon for a lane key; empty (0,2) if absent."""
    if lane_str is None or lane_roi is None:
        return np.zeros((0, 2), dtype=np.float32)
    sub = lane_roi.get(site, {}).get(zone, {})
    if lane_str not in sub:
        return np.zeros((0, 2), dtype=np.float32)
    return np.asarray(sub[lane_str], dtype=np.float32)


def is_trajectory_abnormal(raw_traj: np.ndarray,
                           lane_label: Optional[str] = None,
                           max_step: float = 50.0,
                           max_speed_diff: float = 30.0) -> bool:
    """Reject jumps, jerk spikes, and x-monotonicity violations vs direction."""
    raw_traj = np.asarray(raw_traj, dtype=np.float64)
    if raw_traj.shape[0] < 2:
        return False
    diffs = np.sqrt(np.sum((raw_traj[1:] - raw_traj[:-1]) ** 2, axis=-1))
    if np.any(diffs > max_step):
        return True
    speed_diff = np.abs(diffs[1:] - diffs[:-1])
    if np.any(speed_diff > max_speed_diff):
        return True
    if lane_label is not None:
        x = raw_traj[:, 0]
        if lane_label == "R2L" and np.any(x[1:] > x[:-1]):
            return True
        if lane_label == "L2R" and np.any(x[1:] < x[:-1]):
            return True
    return False
