"""Sliding-window dataset builder producing fixed-shape, pre-padded arrays.

Behavioral parity with ref scripts/train.py:114-259
(``build_dataset_from_tracks_sliding``), redesigned for XLA:

- every output array has a STATIC shape (text padded to ``max_length``,
  polygons to ``max_polygon_points``, vision to ``seq_len``) so the entire
  epoch runs under one jit compilation — no per-batch ``pad_sequence``
  (ref scripts/train.py:301-347) and no recompiles;
- normalization stats are per-window min/max over the full (in+out) window
  (ref scripts/train.py:150-171), stored for later denormalized-MSE loss and
  ADE/FDE;
- labels use -100 over the prompt span (ref scripts/train.py:237-246).

The builder is host-side NumPy; it runs once, then everything is device
arrays.

This is the PyTorch port's own copy of ``tsue_tpu/data/windowing.py``.  It
keeps only the NumPy window scan, which the JAX package documents (and
tests) as bit-identical to its optional C++ path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from tsue_tpu_torch.config import DataConfig
from tsue_tpu_torch.data.filters import (
    filter_context, parse_lane_from_context, get_polygon_from_lane_roi,
    is_trajectory_abnormal)

IGNORE_LABEL = -100


def describe_prompt(track_id, out_len: int, style: str = "describe") -> str:
    """Prompt templates (ref scripts/train.py:200-212; role variant ref
    scripts/im_kim_train_GRN.py:227-234)."""
    if style == "role":
        return (
            "You are an advanced AI that sees the environment from drone-view "
            "videos and reads traffic context. Using the vision tokens and "
            f"the description below, predict the next {out_len} frames of the "
            f"ego vehicle with track_id={track_id}.\n\nAnswer:\n"
        )
    return (
        f"You are analyzing the ego vehicle with track_id={track_id}.\n"
        "Below is partial information about this ego vehicle and its surroundings.\n"
        "Use the provided data (<vision>) to create a comprehensive text describing:\n"
        "1) the ego vehicle's lane, site, and bounding box dimensions,\n"
        "2) velocity, acceleration, and heading info,\n"
        "3) neighbor vehicles,\n"
        "4) average speed in the area.\n\n"
        "Please provide your answer as a natural language paragraph.\n\n"
        "Answer:\n"
    )


@dataclasses.dataclass
class WindowedDataset:
    """Struct-of-arrays dataset; every field is a fixed-shape np/jnp array."""
    traj_in: np.ndarray        # (N, 2, T_in)  normalized [0,1]
    traj_out: np.ndarray       # (N, 2, T_out) normalized [0,1]
    vision: np.ndarray         # (N, T_in, Dv)
    polygon: np.ndarray        # (N, P, 2) raw pixel coords, zero-padded
    polygon_len: np.ndarray    # (N,) int32 valid points
    norm_stat: np.ndarray      # (N, 4) [min_x, max_x, min_y, max_y]
    input_ids: np.ndarray      # (N, L) int32, pad_id-padded
    attention_mask: np.ndarray # (N, L) int32
    labels: np.ndarray         # (N, L) int32, IGNORE_LABEL over prompt+pad
    track_id: np.ndarray       # (N,) int32

    def __len__(self):
        return self.traj_in.shape[0]

    @property
    def size(self):
        return len(self)

    def slice(self, idx) -> "WindowedDataset":
        return WindowedDataset(**{f.name: getattr(self, f.name)[idx]
                                  for f in dataclasses.fields(self)})

    def as_batch_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @staticmethod
    def concatenate(parts: Sequence["WindowedDataset"]) -> "WindowedDataset":
        return WindowedDataset(**{
            f.name: np.concatenate([getattr(p, f.name) for p in parts], axis=0)
            for f in dataclasses.fields(WindowedDataset)})


def _empty(cfg: DataConfig, text_len: int, vision_dim: int) -> WindowedDataset:
    z = lambda *s: np.zeros(s, dtype=np.float32)
    zi = lambda *s: np.zeros(s, dtype=np.int32)
    return WindowedDataset(
        traj_in=z(0, 2, cfg.seq_len), traj_out=z(0, 2, cfg.out_len),
        vision=z(0, cfg.seq_len, vision_dim),
        polygon=z(0, cfg.max_polygon_points, 2), polygon_len=zi(0),
        norm_stat=z(0, 4), input_ids=zi(0, text_len),
        attention_mask=zi(0, text_len), labels=zi(0, text_len),
        track_id=zi(0))


def _numpy_track_windows(raw: np.ndarray, cfg: DataConfig):
    """The per-track window scan; yields
    (start, in (2,T_in), out (2,T_out), stat (4,))."""
    n = raw.shape[0]
    win = cfg.seq_len + cfg.out_len
    out = []
    for start in range(0, n - win + 1, cfg.stride):
        sample = raw[start:start + win]
        min_x, max_x = float(sample[:, 0].min()), float(sample[:, 0].max())
        min_y, max_y = float(sample[:, 1].min()), float(sample[:, 1].max())
        range_x = max_x - min_x
        range_y = max_y - min_y
        if range_x < cfg.min_range_x:
            continue
        if abs(range_x) < 1e-6:
            range_x = 1.0
        if abs(range_y) < 1e-6:
            range_y = 1.0
        norm = np.empty_like(sample)
        norm[:, 0] = (sample[:, 0] - min_x) / range_x
        norm[:, 1] = (sample[:, 1] - min_y) / range_y
        out.append((start, np.ascontiguousarray(norm[:cfg.seq_len].T),
                    np.ascontiguousarray(norm[cfg.seq_len:].T),
                    np.array([min_x, max_x, min_y, max_y], np.float32)))
    return out


def build_windows(tracks: Sequence[dict], cfg: DataConfig,
                  tokenizer=None) -> WindowedDataset:
    """Build the sliding-window dataset from a list of track dicts.

    Mirrors ref scripts/train.py:114-259 filter-by-filter; see module
    docstring for the fixed-shape deltas.

    The numeric inner loops (abnormality scan, window min/max/normalize)
    run in NumPy.
    """
    vision_dim = cfg.vision_dim if cfg.use_vision else 1
    text_len = cfg.max_length if (cfg.use_text and tokenizer is not None) else 1
    P = cfg.max_polygon_points

    rows = {k: [] for k in ("traj_in", "traj_out", "vision", "polygon",
                            "polygon_len", "norm_stat", "input_ids",
                            "attention_mask", "labels", "track_id")}

    for item in tracks:
        raw = item.get("raw_trajectory")
        if raw is None:
            continue
        raw = np.asarray(raw, dtype=np.float32)[::cfg.downsample]
        vis = item.get("vision_embeddings")
        if vis is not None and cfg.use_vision:
            vis = np.asarray(vis, dtype=np.float32)[::cfg.downsample]
        else:
            vis = None

        original_ctx = item.get("context_str", "")
        lane_roi = item.get("lane_roi")
        if lane_roi is None:
            continue
        filtered_ctx, direction = filter_context(original_ctx)
        if filtered_ctx is None:
            continue
        lane_str = parse_lane_from_context(original_ctx)
        if lane_str is None:
            continue
        polygon = get_polygon_from_lane_roi(lane_roi, lane_str)
        abnormal = is_trajectory_abnormal(
            raw, lane_label=direction, max_step=cfg.max_step,
            max_speed_diff=cfg.max_speed_diff)
        if abnormal:
            continue

        n = raw.shape[0]
        win = cfg.seq_len + cfg.out_len
        if n < win:
            continue
        # keep the ORIGINAL id for the prompt text (the ref embeds e.g.
        # 'unknown' verbatim, train.py:204); coerce to int only for the
        # int32 track_id array
        tid_raw = item.get("track_id", item.get("id", "unknown"))
        try:
            tid = int(tid_raw)
        except (TypeError, ValueError):
            tid = -1

        # polygon: clip/pad once per track
        poly_len = min(polygon.shape[0], P)
        poly_fixed = np.zeros((P, 2), dtype=np.float32)
        poly_fixed[:poly_len] = polygon[:poly_len]

        # text: tokenize once per track (prompt depends only on track_id)
        if cfg.use_text and tokenizer is not None:
            prompt_ids = tokenizer.encode(
                describe_prompt(tid_raw, cfg.out_len, cfg.prompt_style),
                max_length=cfg.max_length)
            answer_ids = tokenizer.encode(original_ctx,
                                          max_length=cfg.max_length)
            ids = (prompt_ids + answer_ids)[:cfg.max_length]
            L = len(ids)
            input_ids = np.full((text_len,), tokenizer.pad_id, dtype=np.int32)
            attn = np.zeros((text_len,), dtype=np.int32)
            labels = np.full((text_len,), IGNORE_LABEL, dtype=np.int32)
            input_ids[:L] = ids
            attn[:L] = 1
            p_len = min(len(prompt_ids), L)
            labels[p_len:L] = ids[p_len:L]
        else:
            input_ids = np.zeros((text_len,), dtype=np.int32)
            attn = np.ones((text_len,), dtype=np.int32)
            labels = np.full((text_len,), IGNORE_LABEL, dtype=np.int32)

        for start, w_in, w_out, stat in _numpy_track_windows(raw, cfg):
            rows["traj_in"].append(w_in)                     # (2, T_in)
            rows["traj_out"].append(w_out)                   # (2, T_out)

            if vis is not None:
                v = vis[start:start + cfg.seq_len]
                if v.shape[0] < cfg.seq_len:
                    v = np.concatenate(
                        [v, np.zeros((cfg.seq_len - v.shape[0], v.shape[1]),
                                     dtype=np.float32)], axis=0)
            else:
                v = np.zeros((cfg.seq_len, vision_dim), dtype=np.float32)
            rows["vision"].append(v)
            rows["polygon"].append(poly_fixed)
            rows["polygon_len"].append(poly_len)
            rows["norm_stat"].append(np.asarray(stat, dtype=np.float32))
            rows["input_ids"].append(input_ids)
            rows["attention_mask"].append(attn)
            rows["labels"].append(labels)
            rows["track_id"].append(tid)

    if not rows["traj_in"]:
        return _empty(cfg, text_len, vision_dim)
    if cfg.use_text and tokenizer is not None:
        supervised = sum(int((l != IGNORE_LABEL).sum()) for l in rows["labels"])
        if supervised == 0:
            import warnings
            warnings.warn(
                "build_windows: every label token is masked (-100); the "
                f"prompt likely exceeds max_length={cfg.max_length} under "
                "this tokenizer, so LM training would see zero loss")
    return WindowedDataset(
        traj_in=np.stack(rows["traj_in"]).astype(np.float32),
        traj_out=np.stack(rows["traj_out"]).astype(np.float32),
        vision=np.stack(rows["vision"]).astype(np.float32),
        polygon=np.stack(rows["polygon"]).astype(np.float32),
        polygon_len=np.asarray(rows["polygon_len"], dtype=np.int32),
        norm_stat=np.stack(rows["norm_stat"]).astype(np.float32),
        input_ids=np.stack(rows["input_ids"]).astype(np.int32),
        attention_mask=np.stack(rows["attention_mask"]).astype(np.int32),
        labels=np.stack(rows["labels"]).astype(np.int32),
        track_id=np.asarray(rows["track_id"], dtype=np.int32),
    )
