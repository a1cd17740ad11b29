"""Stage-1 per-track text dataset (D12).

Parity with ``VisionTextDataset`` + ``vision_text_collate_fn``
(ref scripts/check_generation.py:227-311): one row per TRACK (not per
sliding window), whole-track vision embeddings, prompt+answer tokens with
prompt labels masked, and the reference text kept for the generation dump.

TPU-first delta: vision is zero-padded to a fixed ``max_frames`` (the
reference pads to the per-batch max, a recompile per batch under XLA) with
a frame-count array for masking.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from tsue_tpu_torch.config import DataConfig
from tsue_tpu_torch.data.windowing import IGNORE_LABEL, describe_prompt


@dataclasses.dataclass
class TrackTextDataset:
    vision: np.ndarray          # (N, max_frames, Dv)
    vision_len: np.ndarray      # (N,) int32
    input_ids: np.ndarray       # (N, L)
    attention_mask: np.ndarray  # (N, L)
    labels: np.ndarray          # (N, L)
    track_id: np.ndarray        # (N,)
    reference_text: List[str]   # kept for eval dump (ref :284-288)

    def __len__(self):
        return self.vision.shape[0]

    def slice(self, idx):
        idx = np.asarray(idx)
        return TrackTextDataset(
            vision=self.vision[idx], vision_len=self.vision_len[idx],
            input_ids=self.input_ids[idx],
            attention_mask=self.attention_mask[idx],
            labels=self.labels[idx], track_id=self.track_id[idx],
            reference_text=[self.reference_text[int(i)] for i in idx])

    def as_batch_dict(self):
        return {"vision": self.vision, "vision_len": self.vision_len,
                "input_ids": self.input_ids,
                "attention_mask": self.attention_mask,
                "labels": self.labels, "track_id": self.track_id}


def build_track_text_dataset(tracks: Sequence[dict], cfg: DataConfig,
                             tokenizer, max_frames: int = 64,
                             max_length: Optional[int] = None,
                             require_context: bool = True,
                             require_vision: bool = True
                             ) -> TrackTextDataset:
    """One row per track with context; downsampled whole-track vision.

    Training ingest (the defaults) mirrors ``VisionTextDataset``: tracks
    without a context answer or vision embeddings are skipped (ref
    scripts/check_generation.py:233-244).  Serving-side GENERATION only
    needs the prompt — the context is the output, not an input — so the
    Predictor passes ``require_context=False`` (empty answer span, all
    labels ignored) and ``require_vision=False`` (missing embeddings
    become zero frames with ``vision_len`` 0; vision-conditioned serving
    rejects those tracks explicitly before calling this, serve.py)."""
    max_length = max_length or cfg.max_length
    rows = {k: [] for k in ("vision", "vision_len", "input_ids",
                            "attention_mask", "labels", "track_id")}
    texts = []
    for item in tracks:
        ctx = item.get("context_str", "") or ""
        if require_context and not ctx.strip():
            continue
        vis = item.get("vision_embeddings")
        if vis is None:
            if require_vision:
                continue
            vis = np.zeros((0, cfg.vision_dim), np.float32)
        vis = np.asarray(vis, dtype=np.float32)[::cfg.downsample]
        n = min(vis.shape[0], max_frames)
        fixed = np.zeros((max_frames, vis.shape[1]), np.float32)
        fixed[:n] = vis[:n]
        tid = item.get("track_id", item.get("id", -1))
        try:
            tid = int(tid)
        except (TypeError, ValueError):
            tid = -1
        prompt_ids = tokenizer.encode(
            describe_prompt(tid, cfg.out_len, cfg.prompt_style),
            max_length=max_length)
        answer_ids = tokenizer.encode(ctx, max_length=max_length)
        ids = (prompt_ids + answer_ids)[:max_length]
        L = len(ids)
        input_ids = np.full((max_length,), tokenizer.pad_id, np.int32)
        attn = np.zeros((max_length,), np.int32)
        labels = np.full((max_length,), IGNORE_LABEL, np.int32)
        input_ids[:L] = ids
        attn[:L] = 1
        p_len = min(len(prompt_ids), L)
        labels[p_len:L] = ids[p_len:L]
        rows["vision"].append(fixed)
        rows["vision_len"].append(n)
        rows["input_ids"].append(input_ids)
        rows["attention_mask"].append(attn)
        rows["labels"].append(labels)
        rows["track_id"].append(tid)
        texts.append(ctx)
    if not rows["vision"]:
        dv = cfg.vision_dim
        z = lambda *s, d=np.float32: np.zeros(s, d)
        return TrackTextDataset(z(0, max_frames, dv), z(0, d=np.int32),
                                z(0, max_length, d=np.int32),
                                z(0, max_length, d=np.int32),
                                z(0, max_length, d=np.int32),
                                z(0, d=np.int32), [])
    return TrackTextDataset(
        vision=np.stack(rows["vision"]),
        vision_len=np.asarray(rows["vision_len"], np.int32),
        input_ids=np.stack(rows["input_ids"]),
        attention_mask=np.stack(rows["attention_mask"]),
        labels=np.stack(rows["labels"]),
        track_id=np.asarray(rows["track_id"], np.int32),
        reference_text=texts)
