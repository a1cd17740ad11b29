"""Track schema, deterministic splitting, and synthetic fixture generation.

``all_data.pkl`` schema (ref scripts/train.py:128-157): a list of dicts with
keys ``raw_trajectory`` (N,2 float pixel coords), ``vision_embeddings``
(N,512), ``context_str`` (natural-language description), ``lane_roi`` (nested
polygon dict {"Site C": {"A": {"1".."6","safe": [[x,y],...]}}}), ``track_id``.

The port keeps only what its paths and tests use: loading a track pickle,
the lane-ROI tables (:func:`load_lane_roi`, and the reference's Site-C
table vendored as ``site_c_lane_roi.json``, :func:`load_vendored_lane_roi`,
which the plots draw lanes from), the split and the synthetic fixtures (a
parametric lane ROI, :func:`make_synthetic_lane_roi`).

The reference splits with an UNSEEDED in-place shuffle per rank
(ref scripts/train.py:31-39) — rank divergence hazard.  We use the seeded
variant (ref scripts/check_generation.py:316-326, seed 42) so every process
sees the same split.
"""
from __future__ import annotations

import pickle
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_tracks(path: str) -> List[dict]:
    with open(path, "rb") as f:
        data = pickle.load(f)
    if not isinstance(data, list):
        raise ValueError(f"expected a list of track dicts in {path}")
    return data


def load_lane_roi(path: str) -> Dict:
    """Ingest a lane-ROI coordinate table in any of the formats the
    reference ecosystem uses:

    - ``.py``  — reference scripts/graph.py style: a module whose source
      contains ``lane_roi = {...}`` as a literal (ref scripts/graph.py:7-216).
      Parsed with ``ast.literal_eval`` on the assignment's AST node — the
      file is never imported/executed.
    - ``.json`` — the same nested dict serialized as JSON.
    - ``.pkl``/``.pickle`` — either the dict itself or an all_data-style
      track list whose first entry carries ``lane_roi``.

    Returns {site: {zone: {lane: [[x, y], ...]}}} with validation.
    """
    import ast
    import json

    if path.endswith(".py"):
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        roi = None
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "lane_roi"
                    for t in node.targets):
                roi = ast.literal_eval(node.value)
                break
        if roi is None:
            raise ValueError(f"no `lane_roi = {{...}}` literal in {path}")
    elif path.endswith(".json"):
        with open(path) as f:
            roi = json.load(f)
    elif path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            data = pickle.load(f)
        if isinstance(data, list) and data:
            # all_data.pkl layout: list of track dicts carrying lane_roi
            if not isinstance(data[0], dict):
                raise ValueError(
                    f"{path}: expected a list of track dicts, first entry "
                    f"is {type(data[0]).__name__}")
            roi = data[0].get("lane_roi")
            if roi is None:
                raise ValueError(
                    f"{path}: first track dict has no 'lane_roi' key")
        else:
            roi = data
    else:
        raise ValueError(f"unsupported lane-ROI format: {path} "
                         "(want .py/.json/.pkl)")
    _validate_lane_roi(roi, path)
    return roi


def load_vendored_lane_roi() -> Dict:
    """The reference's Site-C lane-ROI table (ref scripts/graph.py:7-216),
    vendored as package data (constant survey coordinates: 7 polygons under
    {"Site C": {"A": ...}} — lanes "1".."6" plus the "safe" zone)."""
    import json
    from pathlib import Path

    path = Path(__file__).with_name("site_c_lane_roi.json")
    with open(path) as f:
        roi = json.load(f)
    _validate_lane_roi(roi, str(path))
    return roi


def _validate_lane_roi(roi, origin: str = "<roi>") -> None:
    if not isinstance(roi, dict) or not roi:
        raise ValueError(f"{origin}: lane_roi must be a non-empty dict")
    for site, zones in roi.items():
        if not isinstance(zones, dict):
            raise ValueError(f"{origin}: site {site!r} must map to zones")
        for zone, lanes in zones.items():
            if not isinstance(lanes, dict):
                raise ValueError(f"{origin}: zone {site}/{zone} must map "
                                 "to lanes")
            for lane, coords in lanes.items():
                arr = np.asarray(coords, dtype=np.float64)
                if arr.ndim != 2 or arr.shape[1] != 2 or arr.shape[0] < 3:
                    raise ValueError(
                        f"{origin}: lane {site}/{zone}/{lane} must be a "
                        f"(N>=3, 2) coordinate list, got shape {arr.shape}")


def split_tracks(tracks: Sequence[dict], train_ratio: float = 0.7,
                 val_ratio: float = 0.2, test_ratio: float = 0.1,
                 seed: int = 42) -> Tuple[List[dict], List[dict], List[dict]]:
    """Deterministic 70/20/10 split (ref scripts/check_generation.py:316-326)."""
    tracks = list(tracks)
    rng = random.Random(seed)
    rng.shuffle(tracks)
    n = len(tracks)
    train_end = int(n * train_ratio)
    val_end = train_end + int(n * val_ratio)
    return tracks[:train_end], tracks[train_end:val_end], tracks[val_end:]


# ---------------------------------------------------------------------------
# Synthetic fixtures
# ---------------------------------------------------------------------------

def make_synthetic_lane_roi(image_width: int = 3840, image_height: int = 1280,
                            num_lanes: int = 6, site: str = "Site C",
                            zone: str = "A", n_points_per_side: int = 12,
                            seed: int = 0) -> Dict:
    """Parametric highway lane map with the reference's nested-dict structure.

    Lanes are horizontal strips spanning the image width; each polygon is a
    jittered closed loop (top edge left->right then bottom edge right->left),
    mimicking surveyed ROI vertices.  A "safe" zone sits below the lanes.
    """
    rng = np.random.default_rng(seed)
    lane_h = image_height * 0.6 / num_lanes
    y0 = image_height * 0.15
    polys = {}
    xs = np.linspace(0, image_width, n_points_per_side)
    for lane in range(1, num_lanes + 1):
        top = y0 + (lane - 1) * lane_h
        bot = top + lane_h
        jit = lambda y: y + rng.uniform(-lane_h * 0.05, lane_h * 0.05, xs.shape)
        top_pts = np.stack([xs, jit(np.full_like(xs, top))], axis=1)
        bot_pts = np.stack([xs[::-1], jit(np.full_like(xs, bot))], axis=1)
        polys[str(lane)] = np.concatenate([top_pts, bot_pts], axis=0).tolist()
    safe_top = y0 + num_lanes * lane_h
    safe_bot = min(safe_top + lane_h, image_height)
    top_pts = np.stack([xs, np.full_like(xs, safe_top)], axis=1)
    bot_pts = np.stack([xs[::-1], np.full_like(xs, safe_bot)], axis=1)
    polys["safe"] = np.concatenate([top_pts, bot_pts], axis=0).tolist()
    return {site: {zone: polys}}


def _context_string(track_id, lane: int, direction: str, speed: float) -> str:
    """A context paragraph shaped like the reference's per-track description
    (lane line "A<k>: ...", direction phrase, neighbors, average speed;
    see filters consumed at ref scripts/train.py:44-76)."""
    dir_phrase = ("moving from left to right" if direction == "L2R"
                  else "moving from right to left")
    return (
        f"A{lane}: The ego vehicle with track_id={track_id} is in lane A{lane} "
        f"at Site C, {dir_phrase} with average speed {speed:.1f} px/frame.\n"
        f"The ego vehicle stays in lane A{lane}. Bounding box is 60x28 pixels. "
        f"Velocity {speed:.1f}, acceleration 0.1, heading steady. "
        "One lead vehicle ahead at 80 px. No left-following vehicle. "
        "No right-following vehicle."
    )


def make_synthetic_tracks(num_tracks: int = 24,
                          track_len: int = 400,
                          vision_dim: int = 512,
                          image_width: int = 3840,
                          image_height: int = 1280,
                          lane_roi: Optional[dict] = None,
                          seed: int = 0,
                          anomaly_fraction: float = 0.0) -> List[dict]:
    """Generate an ``all_data.pkl``-compatible list of smooth highway tracks.

    Tracks are constant-ish velocity with small smooth noise so they pass
    ``is_trajectory_abnormal`` (steps << 50 px, jerk << 30) and produce valid
    sliding windows after downsample=5 (range_x >= 100 over a window needs
    |vx| >= ~100/((18+30)*5) px/frame at raw rate; we use 2-5 px/frame raw).
    """
    rng = np.random.default_rng(seed)
    if lane_roi is None:
        lane_roi = make_synthetic_lane_roi(image_width, image_height)
    tracks = []
    for tid in range(num_tracks):
        lane = int(rng.integers(1, 4))  # only A1-A3 survive filter_context
        direction = "L2R" if rng.random() < 0.5 else "R2L"
        speed = float(rng.uniform(2.0, 5.0))  # px/frame at raw 30fps
        vx = speed if direction == "L2R" else -speed
        x0 = (100.0 if direction == "L2R"
              else image_width - 100.0)
        lane_h = image_height * 0.6 / 6
        ycen = image_height * 0.15 + (lane - 0.5) * lane_h
        t = np.arange(track_len)
        x = x0 + vx * t
        # strictly monotone x (abnormality filter checks monotonicity)
        y = ycen + 3.0 * np.sin(2 * np.pi * t / 300.0)
        traj = np.stack([x, y], axis=1).astype(np.float32)
        if anomaly_fraction > 0 and rng.random() < anomaly_fraction:
            k = int(rng.integers(10, track_len - 10))
            # sustained 200px jump: survives any downsampling rate
            traj[k:] += np.array([200.0 * (1 if vx > 0 else -1), 0.0],
                                 dtype=np.float32)
        vis = rng.standard_normal((track_len, vision_dim)).astype(np.float32)
        tracks.append({
            "raw_trajectory": traj,
            "vision_embeddings": vis,
            "context_str": _context_string(tid, lane, direction, speed * 6),
            "lane_roi": lane_roi,
            "track_id": tid,
        })
    return tracks
