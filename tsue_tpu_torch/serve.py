"""Serving: a batched trajectory predictor on one device.

Counterpart of ``tsue_tpu/serve.py``: ``Predictor`` with ``warmup``,
``predict`` (the deterministic forward and, with ``num_candidates`` K > 0,
the fast K-candidate rollout, per fixed-size chunk of windows) and
``generate_context`` (the stage-1 traffic-context text per track, with the
int8 decode weights, fused LM head and int8 KV cache switches, and
prompt-lookup speculative decoding) and ``generate_context_batched`` (the
same requests through the continuous slot-pool batcher of
``serve_batching.py``, speculative or not, with ``prepare_generation`` to
run every serving width once at startup).  Raw pixel
tracks go through the port's copy of the windowing and text dataset
(``tsue_tpu_torch.data``), which equals the JAX package's, so the port
serves exactly the batches the JAX package serves.

The predictor runs on the CUDA device unless it is given ``device="cpu"``.
``Predictor.from_checkpoint`` serves an artifact that ``run_stage2``
wrote.  Under a mesh (``parallel.mesh.make_mesh``, one process per
device) every rank builds the same ``Predictor``: the weights are its
model-axis shards (``parallel.sharding``), every batch is split over the
data axis and gathered whole, so every rank returns the whole answer.

Usage:
    p = Predictor(cfg, state_dict, num_candidates=10)
    p = Predictor.from_checkpoint(cfg, "runs/test_18_18/ckpt/best",
                                  num_candidates=10)
    out = p.warmup().predict(raw_tracks_px)
    texts = p.generate_context(raw_tracks_px, max_new_tokens=64)
    texts = p.generate_context(raw_tracks_px, speculative=True)
    texts = p.generate_context_batched(raw_tracks_px, max_new_tokens=64,
                                       seed=0, speculative=True)
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from tsue_tpu_torch.config import ExperimentConfig
from tsue_tpu_torch.data import build_windows, get_tokenizer
from tsue_tpu_torch.eval.metrics import fast_candidate_rollout
from tsue_tpu_torch.models.tsue import TrajectoryModel
from tsue_tpu_torch.parallel.sharding import grad_free
from tsue_tpu_torch.train.losses import denorm

MODEL_KEYS = ("traj_in", "polygon", "polygon_len", "vision", "input_ids",
              "attention_mask")


class Predictor:
    """Batched trajectory prediction service for one device."""

    def __init__(self, cfg: ExperimentConfig,
                 params: Mapping[str, torch.Tensor], batch_size: int = 16,
                 num_candidates: int = 0, tokenizer=None,
                 quantize_decode: bool = False, fused_head: bool = False,
                 quantize_kv: bool = False, device="cuda", mesh=None,
                 fsdp: bool = False):
        """``params``: a state dict of ``TrajectoryModel(cfg.model, ...)``
        (``convert.load_flax_params`` fills one from the JAX package's
        parameter tree).  ``device``: the CUDA device by default; the CPU
        (the kernels' plain versions) only when asked for.

        Each parameter takes the dtype of its entry in ``params`` (bf16
        parameters compute in bf16).

        ``quantize_decode``: ``generate_context`` decodes with int8 weights
        (``ops/quant.py``), built once from the parameters.
        ``fused_head``: decode through the fused LM-head + top-k kernel
        (``ops/lmhead_topk.py``), which never materialises the (B, V)
        logits; composes with ``quantize_decode``; the static
        ``generate_context`` path only: the speculative and the batched
        paths keep the plain head (the int8 head under
        ``quantize_decode``), as the JAX package's do.  ``quantize_kv``:
        an int8 KV cache for every generation path, static, speculative
        and batched (``ops/kv_quant.py``; prefill stays exact).
        Prediction is unaffected by all three.

        ``mesh``: a ``parallel.mesh.Mesh`` (every rank of it constructs the
        predictor, with the same one-process ``params``): the model is the
        rank's tensor-parallel shard, on ``mesh.device``; ``batch_size``
        must divide the data axis (each rank runs its rows of every
        chunk); generation goes through ``parallel.serve_tp``'s sharded
        program and the continuous batcher through a slot pool sharded
        over data.  ``fsdp``: the large parameters are also sharded over
        data (FSDP2), gathered layer by layer on use; it needs a mesh
        (``tsue_tpu/serve.py:81-89``)."""
        self.mesh = mesh
        if mesh is not None:
            if batch_size % mesh.data:
                raise ValueError(
                    f"batch_size={batch_size} must divide the mesh's data "
                    f"axis ({mesh.data}): every request chunk is padded to "
                    "batch_size and sharded over data")
            device = mesh.device
        elif fsdp:
            raise ValueError("fsdp=True requires a mesh")
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
        # one continuous batcher per pool shape, least recently used first;
        # bounded because the keys hold request-controlled values
        self._batchers: OrderedDict = OrderedDict()
        self._cache_max = max(4, len(cfg.data.length_buckets) + 2)
        if self.device.type == "cuda":
            # fp32 products stay fp32, as in the JAX package: TF32 keeps
            # about three decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.tokenizer = tokenizer or get_tokenizer()
        if mesh is not None:
            # the rank's shards, placed once (parallel.serve_tp.place,
            # tsue_tpu/serve.py:170-187); the int8 tables built from
            # ``params`` before the cut, the rank's shards attached
            from tsue_tpu_torch.parallel.serve_tp import place
            llm = cfg.model.use_llm
            self.model = place(
                lambda m: TrajectoryModel(cfg.model, cfg.data.seq_len,
                                          cfg.data.out_len, mesh=m),
                params, mesh, fsdp,
                quantize_decode=quantize_decode and llm,
                fused_head=fused_head and llm)
            return
        with torch.device(self.device):
            self.model = TrajectoryModel(cfg.model, cfg.data.seq_len,
                                         cfg.data.out_len)
        # each parameter takes its state's dtype: a bf16 checkpoint serves
        # in bf16, as the JAX package applies its bf16 tree
        for name, p in self.model.named_parameters():
            t = params.get(name)
            if t is not None and t.is_floating_point() and t.dtype != p.dtype:
                p.data = p.data.to(t.dtype)
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
        with.  The parameters stay fp32 under any ``ModelConfig`` dtype and
        each stored value takes their dtype, as the JAX package restores
        into its fp32 init (``tsue_tpu/serve.py:134-140``): a "bfloat16"
        artifact serves bf16-rounded weights with fp32 activations.  The
        JAX package's method initialises from ``key(0)`` where
        its training initialises from ``cfg.train.seed``, and serves a
        frozen-regime artifact over another frozen MLLM than it was trained
        with (ROADMAP C, defects of the reference); the port does not copy
        that.  ``kw`` goes to ``Predictor``."""
        from tsue_tpu_torch.runner import (_check_restore_meta,
                                           build_model_and_params)
        from tsue_tpu_torch.train.checkpoint import restore_merge
        _check_restore_meta(ckpt_dir, mllm_ckpt)
        tokenizer = kw.pop("tokenizer", None) or get_tokenizer()
        mesh = kw.get("mesh")
        device = kw.pop("device", None) or (mesh.device if mesh is not None
                                            else "cuda")
        model = build_model_and_params(cfg, tokenizer, device, mllm_ckpt,
                                       cast=False)
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
        # under a mesh, ``place`` attached the rank's shards
        if self.quantize_decode and self._quant is None and self.mesh is None:
            from tsue_tpu_torch.ops.quant import (attach_quant,
                                                  quantize_llama_params)
            self._quant = quantize_llama_params(mllm)
            attach_quant(mllm, self._quant)
        return mllm

    def generation_program(self, max_new_tokens: int, prompt_len: int,
                           sampling=None, speculative: bool = False):
        """The decode program ``generate_context`` runs for prompts of
        width ``prompt_len``: ``eval.generation.make_generate_fn``, or
        with ``speculative`` ``eval.speculative.make_speculative_generate_fn``
        (greedy when ``sampling`` is None, the plain head)."""
        from tsue_tpu_torch.eval.generation import make_generate_fn
        from tsue_tpu_torch.ops.sampling import SamplingConfig
        if speculative:
            from tsue_tpu_torch.eval.speculative import \
                make_speculative_generate_fn
            prog = make_speculative_generate_fn(
                self._mllm(), sampling or SamplingConfig(do_sample=False),
                max_new_tokens, prompt_len, self.tokenizer.eos_id,
                self.tokenizer.pad_id, quantize_kv=self.quantize_kv)
        else:
            prog = make_generate_fn(
                self._mllm(), sampling or SamplingConfig(), max_new_tokens,
                prompt_len, self.tokenizer.eos_id, self.tokenizer.pad_id,
                fused_head=self.fused_head, quantize_kv=self.quantize_kv)
        if self.mesh is None:
            return prog
        # the rows of every chunk split over data, gathered whole
        from tsue_tpu_torch.parallel.serve_tp import ShardedProgram
        return ShardedProgram(prog, self.mesh)

    @grad_free("model")
    def generate_context(self, tracks: Sequence[dict],
                         max_new_tokens: int = 64,
                         generator: Optional[torch.Generator] = None,
                         sampling=None, speculative: bool = False,
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
        ``speculative=True``: prompt-lookup speculative decoding
        (``eval/speculative.py``; fewer forwards on templated text) with
        the plain head, greedy when ``sampling`` is None (the plain path's
        ids); a sampled config samples and matches, row i of a chunk
        drawing from a CPU generator seeded from ``generator``
        (``_draws``).  ``compile_cap``: decode every request for
        that many steps and trim to ``max_new_tokens`` (a request above the
        cap raises).  Tracks a vision-conditioned model cannot condition
        come back as ``{"track_id", "error"}`` records after the others.

        ``self.last_request`` keeps the request's generated ids (n,
        max_new_tokens), its prompt width and, per chunk, the decode steps
        (or, speculative, the window forwards) run and (on CUDA) the
        prefill and decode device times in ms."""
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
        gen = self.generation_program(cap, width, sampling, speculative)
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
                      self._draws(gen, generator))
            rows.append(out.cpu().numpy()[:len(idx), :max_new_tokens])
            chunks.append({"forwards": gen.forwards} if speculative
                          else {"steps": gen.steps})
            chunks[-1]["batch"] = B
            if self.device.type == "cuda":
                chunks[-1]["prefill_ms"], chunks[-1]["decode_ms"] = \
                    gen.timing_ms()
        ids = np.concatenate(rows)
        self.last_request = {"ids": ids, "width": width, "chunks": chunks}
        texts = [trim_and_decode(row, self.tokenizer) for row in ids]
        return [{"track_id": int(t), "context": txt}
                for t, txt in zip(ds.track_id, texts)] + errs

    def _draws(self, gen, generator: torch.Generator):
        """What decode program ``gen`` draws from: ``generator``, or for a
        sampled speculative program ``batch_size`` CPU generators, one a
        row, seeded from draws of ``generator`` (on any device), so an
        equal generator gives equal rows."""
        from tsue_tpu_torch.eval.speculative import SpeculativeProgram
        prog = getattr(gen, "program", gen)
        if not (isinstance(prog, SpeculativeProgram) and prog.cfg.do_sample):
            return generator
        seeds = torch.randint(2 ** 62, (self.batch_size,),
                              generator=generator,
                              device=generator.device).tolist()
        return [torch.Generator().manual_seed(s) for s in seeds]

    def _serving_widths(self):
        """Prompt widths the length bucketing can emit at serving time: the
        configured buckets below ``max_length`` plus the full width (the
        fallback when a prompt exceeds every bucket)."""
        full = self.cfg.data.max_length
        below = sorted({int(b) for b in self.cfg.data.length_buckets
                        if 1 < b < full})
        return tuple(below) + (full,)

    @grad_free("model")
    def prepare_generation(self, max_new_tokens: int = 64,
                           speculative: bool = False, sampling=None,
                           batched: bool = False,
                           num_slots: Optional[int] = None,
                           chunk: int = 8) -> "Predictor":
        """Run the generation path once per prompt width the request path
        can pick (``_serving_widths``) on a dummy prompt, so that the first
        real request at any width pays no kernel build and no cuBLAS
        set-up (HTTP serving).  One dummy track goes through the request
        path first (ingest and the smallest width).  ``batched``: the
        continuous batcher's path (``num_slots`` slots, default
        ``batch_size``), else the static one; ``speculative``: their
        speculative forms (``_spec_window`` in the pool)."""
        if not self.cfg.model.use_llm:
            raise ValueError("prepare_generation needs a use_llm=True model")
        d = self.cfg.data
        track = {"track_id": 0, "context_str": "warmup",
                 "vision_embeddings": np.zeros((d.downsample, d.vision_dim),
                                               np.float32)}
        if batched:
            self.generate_context_batched(
                [track], max_new_tokens=max_new_tokens, sampling=sampling,
                num_slots=num_slots, chunk=chunk, speculative=speculative)
        else:
            self.generate_context([track], max_new_tokens=max_new_tokens,
                                  sampling=sampling, speculative=speculative)
        for w in self._serving_widths():
            ids = np.zeros((1, w), np.int32)
            mask = np.zeros((1, w), np.int32)
            ids[0, :4] = 5
            mask[0, :4] = 1
            vis = np.zeros((1, d.downsample, d.vision_dim), np.float32)
            if batched:
                req = {"prompt_ids": ids[0], "prompt_mask": mask[0]}
                if self.cfg.model.use_vision:
                    req["vision"] = vis[0]
                self._batcher(num_slots or self.batch_size, w,
                              max_new_tokens, chunk, sampling,
                              self._spec_window(speculative, None,
                                                sampling)).run([req])
            else:
                reps = (self.batch_size, 1)
                gen = self.generation_program(max_new_tokens, w, sampling,
                                              speculative)
                gen(torch.from_numpy(np.tile(vis, reps + (1,))).to(self.device)
                    if self.cfg.model.use_vision else None,
                    torch.from_numpy(np.tile(ids, reps)).to(self.device),
                    torch.from_numpy(np.tile(mask, reps)).to(self.device),
                    self._draws(gen, self._generator(0)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _batcher(self, num_slots: int, prompt_len: int, max_new_tokens: int,
                 chunk: int, sampling, window: int = 1):
        """The cached continuous batcher of this pool shape."""
        key = (num_slots, prompt_len, max_new_tokens, chunk, repr(sampling),
               window)
        if key in self._batchers:
            self._batchers.move_to_end(key)
            return self._batchers[key]
        batcher = self._batchers[key] = self.continuous_batcher(
            num_slots=num_slots, prompt_len=prompt_len,
            max_new_tokens=max_new_tokens, chunk=chunk, sampling=sampling,
            window=window)
        while len(self._batchers) > self._cache_max:
            self._batchers.popitem(last=False)
        return batcher

    def continuous_batcher(self, num_slots: int = 16,
                           prompt_len: Optional[int] = None,
                           max_new_tokens: int = 64, chunk: int = 8,
                           sampling=None, window: int = 1):
        """A ``serve_batching.ContinuousBatcher`` over this predictor's MLLM
        (with its int8 tables when ``quantize_decode``, and an int8 pool
        cache when ``quantize_kv``).  The batcher samples from the full
        logits, so it refuses ``fused_head``: the JAX package's method
        drops that switch without a word (``tsue_tpu/serve.py:573-603``).
        ``window >= 2``: the speculative window mode, whose ids are the
        window-1 pool's."""
        if not self.cfg.model.use_llm:
            raise ValueError("continuous_batcher needs a use_llm=True model")
        if self.fused_head:
            raise ValueError(
                "the continuous batcher does not take fused_head=True: it "
                "samples from the full logits; build the Predictor without "
                "fused_head, or serve with the static batcher")
        from tsue_tpu_torch.ops.sampling import SamplingConfig
        from tsue_tpu_torch.serve_batching import ContinuousBatcher
        return ContinuousBatcher(
            self._mllm(), sampling or SamplingConfig(), num_slots=num_slots,
            prompt_len=(prompt_len if prompt_len is not None
                        else self.cfg.data.max_length),
            max_new_tokens=max_new_tokens, eos_id=self.tokenizer.eos_id,
            pad_id=self.tokenizer.pad_id, chunk=chunk, window=window,
            quantize_kv=self.quantize_kv, device=self.device,
            mesh=self.mesh)

    @grad_free("model")
    def generate_context_batched(self, tracks: Sequence[dict],
                                 max_new_tokens: int = 64, seed: int = 0,
                                 sampling=None,
                                 num_slots: Optional[int] = None,
                                 chunk: int = 8,
                                 compile_cap: Optional[int] = None,
                                 speculative: bool = False,
                                 spec_window: Optional[int] = None
                                 ) -> List[Dict]:
        """``generate_context`` through the continuous batcher's slot pool
        (``num_slots`` slots, default ``batch_size``; harvested every
        ``chunk`` ticks): the same request semantics (prompt-only
        conditioning, length buckets, ``compile_cap``, error records for
        tracks a vision-conditioned model cannot condition), scheduled with
        continuous refill.  Track i draws from its own CPU generator,
        ``utils.random.step_generator(seed, i)`` (the JAX package's
        ``fold_in(key(seed), i)``), so its text does not depend on what
        shares the pool.  ``speculative=True`` runs the pool's window mode,
        ``spec_window`` tokens a tick (``_spec_window``): the same ids,
        fewer forwards on templated text.

        ``self.last_request`` keeps the request's generated ids (one array
        per track), its prompt width and the pool's ``last_run``."""
        if not self.cfg.model.use_llm:
            raise ValueError("generate_context_batched needs a use_llm=True "
                             "model")
        from tsue_tpu_torch.eval.generation import postprocess_text
        reqs, track_ids, width, errs = self.generation_requests(tracks, seed)
        if not reqs:
            return errs
        cap = self._resolve_cap(compile_cap, max_new_tokens)
        window = self._spec_window(speculative, spec_window, sampling)
        batcher = self._batcher(num_slots or self.batch_size, width, cap,
                                chunk, sampling, window)
        rows = [row[:max_new_tokens] for row in batcher.run(reqs)]
        self.last_request = {"ids": rows, "width": width,
                             "pool": batcher.last_run}
        pad = self.tokenizer.pad_id
        texts = [postprocess_text(self.tokenizer.decode(
            [int(t) for t in row if t != pad])) for row in rows]
        return [{"track_id": int(t), "context": txt}
                for t, txt in zip(track_ids, texts)] + errs

    @staticmethod
    def _spec_window(speculative: bool, spec_window: Optional[int],
                     sampling) -> int:
        """The pool's window: 1 (off) unless ``speculative``, then
        ``spec_window`` or the JAX package's measured defaults, 8 greedy
        and 4 sampled (``tsue_tpu/serve.py:560-571``)."""
        if not speculative:
            if spec_window not in (None, 1):
                raise ValueError("spec_window requires speculative=True")
            return 1
        if spec_window is not None:
            return spec_window
        return 4 if (sampling is not None and sampling.do_sample) else 8

    def generation_requests(self, tracks: Sequence[dict], seed: int = 0):
        """The continuous batcher's requests for ``tracks``: (requests,
        track ids, prompt width, error records).  Prompt-only conditioning
        over the smallest covering length bucket, as ``generate_context``;
        request i draws from ``utils.random.step_generator(seed, i)``."""
        from tsue_tpu_torch.data.text_dataset import build_track_text_dataset
        from tsue_tpu_torch.utils.random import step_generator
        tracks, errs = self._generation_tracks(tracks)
        ds = build_track_text_dataset(tracks, self.cfg.data, self.tokenizer,
                                      require_context=False,
                                      require_vision=False)
        if len(ds) == 0:
            return [], [], 0, errs
        prompt_mask = np.asarray(ds.attention_mask * (ds.labels == -100),
                                 np.int32)
        prompt_ids = np.asarray(ds.input_ids, np.int32) * prompt_mask
        prompt_ids, prompt_mask, width = self._bucket_prompts(
            prompt_ids, prompt_mask)
        reqs = []
        for i in range(len(ds)):
            r = {"prompt_ids": prompt_ids[i], "prompt_mask": prompt_mask[i],
                 "generator": step_generator(seed, i)}
            if self.cfg.model.use_vision:
                r["vision"] = ds.vision[i]
            reqs.append(r)
        return reqs, list(ds.track_id), width, errs

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.mesh is None:
            return self.model(batch)
        from tsue_tpu_torch.parallel.mesh import all_gather_cat, shard_batch
        return all_gather_cat(self.model(shard_batch(batch, self.mesh)),
                              self.mesh.data_group, 0)

    def _rollout(self, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator) -> torch.Tensor:
        if self.mesh is None:
            return fast_candidate_rollout(self.model, batch,
                                          self.num_candidates, generator)
        from tsue_tpu_torch.parallel.mesh import all_gather_cat, shard_batch
        from tsue_tpu_torch.parallel.serve_tp import data_rank_generator
        if self.mesh.data > 1:
            generator = data_rank_generator(generator, self.mesh)
        return all_gather_cat(fast_candidate_rollout(
            self.model, shard_batch(batch, self.mesh), self.num_candidates,
            generator), self.mesh.data_group, 0)

    @grad_free("model")
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

    @grad_free("model")
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
