"""Visualization suite: the reference's full PNG artifact set.

The port's copy of ``tsue_tpu/viz/plots.py``.  matplotlib is imported
inside the functions (``_plt``), so the package imports where matplotlib
is absent; plotting there raises ``ImportError``.

Parity targets (all rank-0-only host-side matplotlib):
- past/GT/pred overlay            (ref scripts/train.py:969-1039)
- K-candidate plot                (ref scripts/test.py:967-1064)
- best-of-K plot                  (ref scripts/seed_fix_train.py:929-1000)
- X/Y-vs-time plots               (ref modify_scripts/capstone_project.py:1394-1423)
- lane-ROI polygon map            (ref scripts/graph.py:218-251)
- publication figure: many trajectories over the ROI map
                                  (ref scripts/plot.py:1019-1078)

All functions take NumPy arrays in *pixel* coordinates (denormalize before
calling; see tsue_tpu_torch.train.losses.denorm), save a PNG, return its
path.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    """matplotlib's pyplot on the Agg backend (no display), imported at
    the first plot."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, save_dir: str, name: str) -> str:
    plt = _plt()
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def _xy(traj: np.ndarray):
    """Accept (2, T) or (T, 2); return (xs, ys)."""
    traj = np.asarray(traj)
    if traj.shape[0] == 2 and traj.ndim == 2 and traj.shape[1] != 2:
        return traj[0], traj[1]
    return traj[:, 0], traj[:, 1]


def plot_one_sample(past: np.ndarray, gt: np.ndarray, pred: np.ndarray,
                    save_dir: str, prefix: str = "sample", idx: int = 0,
                    polygon: Optional[np.ndarray] = None) -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    if polygon is not None and len(polygon):
        poly = np.asarray(polygon)
        ax.fill(poly[:, 0], poly[:, 1], alpha=0.15, color="gray",
                label="lane ROI")
    for traj, style, label in ((past, "o-", "past"), (gt, "s-", "ground truth"),
                               (pred, "^--", "prediction")):
        xs, ys = _xy(traj)
        ax.plot(xs, ys, style, label=label, markersize=3)
    ax.legend(); ax.set_xlabel("x [px]"); ax.set_ylabel("y [px]")
    ax.invert_yaxis()  # image coordinates
    return _save(fig, save_dir, f"{prefix}_{idx}.png")


def plot_candidates(past: np.ndarray, gt: np.ndarray, cands: np.ndarray,
                    save_dir: str, prefix: str = "candidates",
                    idx: int = 0) -> str:
    """cands: (K, 2, T) or (K, T, 2)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    for k in range(len(cands)):
        xs, ys = _xy(cands[k])
        ax.plot(xs, ys, "--", color="tab:orange", alpha=0.4,
                label="candidates" if k == 0 else None)
    for traj, style, color, label in ((past, "o-", "tab:blue", "past"),
                                      (gt, "s-", "tab:green", "ground truth")):
        xs, ys = _xy(traj)
        ax.plot(xs, ys, style, color=color, label=label, markersize=3)
    ax.legend(); ax.set_xlabel("x [px]"); ax.set_ylabel("y [px]")
    ax.invert_yaxis()
    return _save(fig, save_dir, f"{prefix}_{idx}.png")


def plot_best_of_k(past: np.ndarray, gt: np.ndarray, cands: np.ndarray,
                   save_dir: str, prefix: str = "best_of_k",
                   idx: int = 0) -> str:
    """Highlight the min-ADE candidate (ref seed_fix_train.py:929-1000)."""
    plt = _plt()
    cands = np.asarray(cands)
    gt_xy = np.stack(_xy(gt), axis=0)
    errs = []
    for k in range(len(cands)):
        xs, ys = _xy(cands[k])
        errs.append(np.mean(np.hypot(xs - gt_xy[0], ys - gt_xy[1])))
    best = int(np.argmin(errs))
    fig, ax = plt.subplots(figsize=(8, 5))
    for k in range(len(cands)):
        xs, ys = _xy(cands[k])
        if k == best:
            continue
        ax.plot(xs, ys, "--", color="lightgray", alpha=0.6)
    xs, ys = _xy(cands[best])
    ax.plot(xs, ys, "^--", color="tab:red",
            label=f"best of {len(cands)} (ADE {errs[best]:.1f}px)")
    for traj, style, color, label in ((past, "o-", "tab:blue", "past"),
                                      (gt, "s-", "tab:green", "ground truth")):
        x2, y2 = _xy(traj)
        ax.plot(x2, y2, style, color=color, label=label, markersize=3)
    ax.legend(); ax.invert_yaxis()
    return _save(fig, save_dir, f"{prefix}_{idx}.png")


def plot_xy_time(gt: np.ndarray, preds: Sequence[np.ndarray], save_dir: str,
                 prefix: str = "xy_time", idx: int = 0, fps: float = 6.0) -> str:
    """X(t) and Y(t) panels, N sampled predictions vs GT
    (ref capstone_project.py:1394-1423)."""
    plt = _plt()
    fig, (ax_x, ax_y) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    gx, gy = _xy(gt)
    t = np.arange(len(gx)) / fps
    ax_x.plot(t, gx, "k-", lw=2, label="GT")
    ax_y.plot(t, gy, "k-", lw=2, label="GT")
    for i, p in enumerate(preds):
        px, py = _xy(p)
        ax_x.plot(t[:len(px)], px, "--", alpha=0.6,
                  label=f"sample {i}" if i < 5 else None)
        ax_y.plot(t[:len(py)], py, "--", alpha=0.6)
    ax_x.set_ylabel("x [px]"); ax_y.set_ylabel("y [px]")
    ax_y.set_xlabel("t [s]"); ax_x.legend(fontsize=7)
    return _save(fig, save_dir, f"{prefix}_{idx}.png")


def _select_zone(lane_roi: Dict, site: Optional[str],
                 zone: Optional[str]) -> Dict:
    """Resolve {site: {zone: {lane: coords}}} to one zone's lane dict.

    ``site``/``zone`` None auto-select when the table has exactly one
    entry at that level; a missing or ambiguous key raises naming the
    available keys — a wrong key must never render a silently empty map.
    """
    def pick(table: Dict, key: Optional[str], level: str) -> Dict:
        if key is None:
            if len(table) == 1:
                return next(iter(table.values()))
            raise ValueError(f"ambiguous {level}: specify one of "
                             f"{sorted(table)}")
        if key not in table:
            raise ValueError(f"{level} {key!r} not in ROI table; "
                             f"available: {sorted(table)}")
        return table[key]
    return pick(pick(lane_roi, site, "site"), zone, "zone")


def plot_lane_roi_map(lane_roi: Dict, save_dir: str,
                      site: Optional[str] = "Site C",
                      zone: Optional[str] = "A",
                      name: str = "lane_roi_map.png",
                      transparent: bool = True,
                      image_size=(3840, 1280)) -> str:
    """Polygon map with per-lane colors (ref scripts/graph.py:218-251)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 4))
    cmap = plt.get_cmap("tab10")
    for i, (lane, coords) in enumerate(
            sorted(_select_zone(lane_roi, site, zone).items())):
        poly = np.asarray(coords, dtype=float)
        if not len(poly):
            continue
        ax.fill(poly[:, 0], poly[:, 1], alpha=0.35, color=cmap(i % 10),
                label=f"lane {lane}")
    ax.set_xlim(0, image_size[0]); ax.set_ylim(image_size[1], 0)
    ax.legend(fontsize=7, ncols=4)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    fig.savefig(path, dpi=120, transparent=transparent, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_trajectories_over_map(samples: Sequence[Dict], lane_roi: Dict,
                               save_dir: str, name: str = "all_trajectories.png",
                               site: Optional[str] = "Site C",
                               zone: Optional[str] = "A",
                               image_size=(3840, 1280)) -> str:
    """Publication figure: every sample's past/GT/pred over the ROI map
    (ref scripts/plot.py:1019-1078).  samples: dicts with past/gt/pred."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(14, 5))
    for lane, coords in sorted(_select_zone(lane_roi, site, zone).items()):
        poly = np.asarray(coords, dtype=float)
        if len(poly):
            ax.fill(poly[:, 0], poly[:, 1], alpha=0.15, color="gray")
    for i, s in enumerate(samples):
        lbl = (lambda n: n if i == 0 else None)
        for key, style, color in (("past", "-", "tab:blue"),
                                  ("gt", "-", "tab:green"),
                                  ("pred", "--", "tab:red")):
            if key in s:
                xs, ys = _xy(s[key])
                ax.plot(xs, ys, style, color=color, lw=1, alpha=0.7,
                        label=lbl(key))
    ax.set_xlim(0, image_size[0]); ax.set_ylim(image_size[1], 0)
    ax.legend(fontsize=8)
    return _save(fig, save_dir, name)
