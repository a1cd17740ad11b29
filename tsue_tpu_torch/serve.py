"""Serving: a batched trajectory predictor on one device.

Counterpart of ``tsue_tpu/serve.py``: ``Predictor`` with ``warmup``,
``predict`` (the deterministic forward and, with ``num_candidates`` K > 0,
the fast K-candidate rollout, per fixed-size chunk of windows) and
``generate_context`` (the stage-1 traffic-context text per track, with the
int8 decode weights, fused LM head and int8 KV cache switches).  Raw pixel
tracks go through the port's copy of the windowing and text dataset
(``tsue_tpu_torch.data``), which equals the JAX package's, so the port
serves exactly the batches the JAX package serves.

The predictor runs on the CUDA device unless it is given ``device="cpu"``.
``Predictor.from_checkpoint`` serves an artifact that ``run_stage2``
wrote.  Speculative decoding, the continuous batcher and meshes are not
ported yet, so the methods do not take those options.

Usage:
    p = Predictor(cfg, state_dict, num_candidates=10)
    p = Predictor.from_checkpoint(cfg, "runs/test_18_18/ckpt/best",
                                  num_candidates=10)
    out = p.warmup().predict(raw_tracks_px)
    texts = p.generate_context(raw_tracks_px, max_new_tokens=64)
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from tsue_tpu_torch.config import ExperimentConfig
from tsue_tpu_torch.data import build_windows, get_tokenizer
from tsue_tpu_torch.eval.metrics import fast_candidate_rollout
from tsue_tpu_torch.models.tsue import TrajectoryModel
from tsue_tpu_torch.train.losses import denorm

MODEL_KEYS = ("traj_in", "polygon", "polygon_len", "vision", "input_ids",
              "attention_mask")


class Predictor:
    """Batched trajectory prediction service for one device."""

    def __init__(self, cfg: ExperimentConfig,
                 params: Mapping[str, torch.Tensor], batch_size: int = 16,
                 num_candidates: int = 0, tokenizer=None,
                 quantize_decode: bool = False, fused_head: bool = False,
                 quantize_kv: bool = False, device="cuda"):
        """``params``: a state dict of ``TrajectoryModel(cfg.model, ...)``
        (``convert.load_flax_params`` fills one from the JAX package's
        parameter tree).  ``device``: the CUDA device by default; the CPU
        (the kernels' plain versions) only when asked for.

        ``quantize_decode``: ``generate_context`` decodes with int8 weights
        (``ops/quant.py``), built once from the fp32 parameters.
        ``fused_head``: decode through the fused LM-head + top-k kernel
        (``ops/lmhead_topk.py``), which never materialises the (B, V)
        logits; composes with ``quantize_decode``.  ``quantize_kv``: an
        int8 KV cache for generation (``ops/kv_quant.py``; prefill stays
        exact).  Prediction is unaffected by all three."""
        self.cfg = cfg
        self.batch_size = batch_size
        self.num_candidates = num_candidates
        self.quantize_decode = quantize_decode
        self.fused_head = fused_head
        self.quantize_kv = quantize_kv
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor runs on the CUDA device by default "
                               "and none is available; pass device='cpu' "
                               "to run on the CPU")
        if fused_head and batch_size >= 32:
            import warnings
            warnings.warn(
                f"fused_head=True at batch_size={batch_size}: the fused "
                "LM-head+top-k kernel is a small-batch latency lever; the "
                "JAX package measured it slower than the plain head at "
                "batch 64 and 128 — consider leaving it off at this batch "
                "size")
        self._quant = None
        self.last_request: Optional[Dict] = None
        if self.device.type == "cuda":
            # fp32 products stay fp32, as in the JAX package: TF32 keeps
            # about three decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.tokenizer = tokenizer or get_tokenizer()
        with torch.device(self.device):
            self.model = TrajectoryModel(cfg.model, cfg.data.seq_len,
                                         cfg.data.out_len)
        self.model.load_state_dict(params, strict=True)
        self.model.eval()

    @classmethod
    def from_checkpoint(cls, cfg: ExperimentConfig, ckpt_dir: str,
                        mllm_ckpt: Optional[str] = None,
                        **kw) -> "Predictor":
        """A predictor over a ``run_stage2`` artifact (full, or the
        trainable subset of a frozen regime), merged by
        ``train.checkpoint.restore_merge`` over the model that
        ``runner.build_model_and_params`` builds: the vocabulary resized to
        the tokenizer's, random weights from ``cfg.train.seed`` and, with
        ``mllm_ckpt``, the stage-1 artifact the training imported (a
        checkpoint whose ``meta.json`` records one raises without it).  So
        the frozen parameters are the ones the checkpoint was trained
        with.  The JAX package's method initialises from ``key(0)`` where
        its training initialises from ``cfg.train.seed``, and serves a
        frozen-regime artifact over another frozen MLLM than it was trained
        with (ROADMAP C, defects of the reference); the port does not copy
        that.  ``kw`` goes to ``Predictor``."""
        from tsue_tpu_torch.runner import (_check_restore_meta,
                                           build_model_and_params)
        from tsue_tpu_torch.train.checkpoint import restore_merge
        _check_restore_meta(ckpt_dir, mllm_ckpt)
        tokenizer = kw.pop("tokenizer", None) or get_tokenizer()
        device = kw.pop("device", "cuda")
        model = build_model_and_params(cfg, tokenizer, device, mllm_ckpt)
        restore_merge(ckpt_dir, model)
        return cls(cfg.replace(model=model.cfg), model.state_dict(),
                   tokenizer=tokenizer, device=device, **kw)

    @staticmethod
    def _resolve_cap(compile_cap: Optional[int], max_new_tokens: int) -> int:
        """A pinned ``compile_cap`` is the decode length every request
        runs; a request above it fails loudly instead of growing it."""
        if compile_cap is None:
            return max_new_tokens
        if max_new_tokens > compile_cap:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} exceeds "
                f"compile_cap={compile_cap}: clamp the request or raise the "
                "cap")
        return compile_cap

    def _bucket_prompts(self, prompt_ids: np.ndarray,
                        prompt_mask: np.ndarray):
        """Trim the request's prompt arrays to the smallest configured
        length bucket covering its longest prompt row
        (``DataConfig.length_buckets``).  Prompt tokens occupy a prefix of
        each row, so trimming drops only all-pad tail positions.  Returns
        (ids, mask, width)."""
        width = prompt_ids.shape[1]
        buckets = tuple(self.cfg.data.length_buckets)
        if not buckets or width <= 1:
            return prompt_ids, prompt_mask, width
        longest = int(prompt_mask.sum(axis=1).max()) if len(prompt_mask) \
            else 0
        bucket = next((b for b in buckets if b >= longest), width)
        if bucket >= width:
            return prompt_ids, prompt_mask, width
        return prompt_ids[:, :bucket], prompt_mask[:, :bucket], bucket

    def _generation_tracks(self, tracks: Sequence[dict]):
        """Split tracks into (usable, error records) for generation: a
        vision-conditioned model cannot condition a track without
        ``vision_embeddings``, which comes back as an explicit
        ``{"track_id", "error"}`` record (``context_str`` is the output, not
        a requirement)."""
        ok, errs = [], []
        need_vision = self.cfg.model.use_vision
        for t in tracks:
            tid = t.get("track_id", t.get("id", -1))
            try:
                tid = int(tid)
            except (TypeError, ValueError):
                tid = -1
            if need_vision and t.get("vision_embeddings") is None:
                errs.append({"track_id": tid, "error":
                             "missing vision_embeddings "
                             "(model is vision-conditioned)"})
            else:
                ok.append(t)
        return ok, errs

    def _mllm(self):
        """The MLLM with its int8 tables attached when ``quantize_decode``
        (built once from the fp32 parameters)."""
        mllm = self.model.mllm
        if self.quantize_decode and self._quant is None:
            from tsue_tpu_torch.ops.quant import (attach_quant,
                                                  quantize_llama_params)
            self._quant = quantize_llama_params(mllm)
            attach_quant(mllm, self._quant)
        return mllm

    def generation_program(self, max_new_tokens: int, prompt_len: int,
                           sampling=None):
        """The decode program ``generate_context`` runs for prompts of
        width ``prompt_len`` (``eval.generation.make_generate_fn``)."""
        from tsue_tpu_torch.eval.generation import make_generate_fn
        from tsue_tpu_torch.ops.sampling import SamplingConfig
        return make_generate_fn(
            self._mllm(), sampling or SamplingConfig(), max_new_tokens,
            prompt_len, self.tokenizer.eos_id, self.tokenizer.pad_id,
            fused_head=self.fused_head, quantize_kv=self.quantize_kv)

    @torch.inference_mode()
    def generate_context(self, tracks: Sequence[dict],
                         max_new_tokens: int = 64,
                         generator: Optional[torch.Generator] = None,
                         sampling=None,
                         compile_cap: Optional[int] = None) -> List[Dict]:
        """Generate traffic-context text per track (stage-1 capability).

        Requires cfg.model.use_llm.  Prompt-only conditioning (the answer
        span is masked out), prompts trimmed to the smallest covering
        length bucket, then the KV-cached decoder in fixed ``batch_size``
        chunks (a short last chunk repeats its last track).  ``sampling``
        defaults to ``SamplingConfig()`` (sampled, the reference's HF
        settings); its draws come from ``generator`` (a generator on the
        predictor's device; seed 0 when None), consumed chunk by chunk, so
        a request repeated with an equal generator gives equal text.
        ``compile_cap``: decode every request for that many steps and trim
        to ``max_new_tokens`` (a request above the cap raises).  Tracks a
        vision-conditioned model cannot condition come back as
        ``{"track_id", "error"}`` records after the others.

        ``self.last_request`` keeps the request's generated ids (n,
        max_new_tokens), its prompt width and, per chunk, the decode steps
        run and (on CUDA) the prefill and decode device times in ms."""
        if not self.cfg.model.use_llm:
            raise ValueError("generate_context needs a use_llm=True model")
        from tsue_tpu_torch.data.text_dataset import build_track_text_dataset
        from tsue_tpu_torch.eval.generation import trim_and_decode
        tracks, errs = self._generation_tracks(tracks)
        ds = build_track_text_dataset(tracks, self.cfg.data, self.tokenizer,
                                      require_context=False,
                                      require_vision=False)
        n = len(ds)
        if n == 0:
            return errs
        generator = generator or self._generator(0)
        cap = self._resolve_cap(compile_cap, max_new_tokens)
        prompt_mask = np.asarray(ds.attention_mask * (ds.labels == -100),
                                 np.int32)
        prompt_ids = np.asarray(ds.input_ids, np.int32) * prompt_mask
        prompt_ids, prompt_mask, width = self._bucket_prompts(
            prompt_ids, prompt_mask)
        gen = self.generation_program(cap, width, sampling)
        B = self.batch_size
        rows = []
        chunks = []
        for s in range(0, n, B):
            idx = np.arange(s, min(s + B, n))
            sel = np.concatenate([idx, np.repeat(idx[-1:], B - len(idx))])
            vision = (torch.from_numpy(ds.vision[sel]).to(self.device)
                      if self.cfg.model.use_vision else None)
            out = gen(vision,
                      torch.from_numpy(prompt_ids[sel]).to(self.device),
                      torch.from_numpy(prompt_mask[sel]).to(self.device),
                      generator)
            rows.append(out.cpu().numpy()[:len(idx), :max_new_tokens])
            chunks.append({"steps": gen.steps, "batch": B})
            if self.device.type == "cuda":
                chunks[-1]["prefill_ms"], chunks[-1]["decode_ms"] = \
                    gen.timing_ms()
        ids = np.concatenate(rows)
        self.last_request = {"ids": ids, "width": width, "chunks": chunks}
        texts = [trim_and_decode(row, self.tokenizer) for row in ids]
        return [{"track_id": int(t), "context": txt}
                for t, txt in zip(ds.track_id, texts)] + errs

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model(batch)

    def _rollout(self, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator) -> torch.Tensor:
        return fast_candidate_rollout(self.model, batch, self.num_candidates,
                                      generator)

    @torch.inference_mode()
    def warmup(self) -> "Predictor":
        """Run every program once on dummy data (builds the kernels)."""
        b = self._dummy_batch()
        self._predict(b)
        if self.num_candidates:
            self._rollout(b, self._generator(0))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _dummy_batch(self) -> Dict[str, torch.Tensor]:
        d = self.cfg.data
        B = self.batch_size
        vd = d.vision_dim if d.use_vision else 1
        L = d.max_length if d.use_text else 1
        kw = dict(device=self.device)
        return {
            "traj_in": torch.zeros(B, 2, d.seq_len, **kw),
            "polygon": torch.zeros(B, d.max_polygon_points, 2, **kw),
            "polygon_len": torch.zeros(B, dtype=torch.int32, **kw),
            "vision": torch.zeros(B, d.seq_len, vd, **kw),
            "input_ids": torch.zeros(B, L, dtype=torch.int32, **kw),
            "attention_mask": torch.ones(B, L, dtype=torch.int32, **kw),
        }

    @torch.inference_mode()
    def predict(self, tracks: Sequence[dict],
                generator: Optional[torch.Generator] = None) -> List[Dict]:
        """Raw track dicts (all_data.pkl schema) -> per-window pixel
        predictions, one record per window: {track_id, past_pixel_xy
        (2, T_in), pred_pixel_xy (2, T_out)[, candidates_pixel_xy
        (K, 2, T_out)]}.  The candidates' dropout masks come from
        ``generator`` (a generator on the predictor's device; seed 0 when
        None), so a request repeated with an equal generator gives equal
        candidates."""
        ds = build_windows(tracks, self.cfg.data, self.tokenizer
                           if self.cfg.data.use_text else None)
        n = len(ds)
        if n == 0:
            return []
        generator = generator or self._generator(0)
        results: List[Dict] = []
        B = self.batch_size
        for s in range(0, n, B):
            idx = np.arange(s, min(s + B, n))
            # a short last chunk repeats its last window up to batch_size
            sel = np.concatenate([idx, np.repeat(idx[-1:], B - len(idx))])
            full = ds.slice(sel).as_batch_dict()
            batch = {k: torch.from_numpy(full[k]).to(self.device)
                     for k in MODEL_KEYS}
            norm_stat = torch.from_numpy(full["norm_stat"]).to(self.device)
            pred_px = denorm(self._predict(batch), norm_stat).cpu().numpy()
            past_px = denorm(batch["traj_in"], norm_stat).cpu().numpy()
            cands_px = None
            if self.num_candidates:
                K = self.num_candidates
                cands = self._rollout(batch, generator)
                cands_px = denorm(
                    cands.reshape(B * K, 2, -1),
                    norm_stat.repeat_interleave(K, dim=0)
                ).reshape(B, K, 2, -1).cpu().numpy()
            for j in range(len(idx)):
                rec = {"track_id": int(full["track_id"][j]),
                       "past_pixel_xy": past_px[j],
                       "pred_pixel_xy": pred_px[j]}
                if cands_px is not None:
                    rec["candidates_pixel_xy"] = cands_px[j]
                results.append(rec)
        return results
