"""Slot-pool continuous batching for text generation serving.

Counterpart of ``tsue_tpu/serve_batching.py``.  The static generator
(``eval/generation.py``) runs one batch until every row has stopped, so a
batch's wall time is that of its longest member.  ``ContinuousBatcher``
keeps a fixed pool of decode slots and refills each slot as soon as its
request finishes, so the device's work follows the mean output length
instead of the longest.

Mechanics:

- the pool state (``PoolState``) is tensors on the device: the KV caches,
  the sampler history, per-slot step counters, output buffers and flags;
- a decode chunk is a Python loop of ``chunk`` ticks over the whole pool,
  each one ``MultiModalLLM.decode_step`` with per-slot steps (every row
  writes its own cache slot); a finished or empty slot rides along with
  its step frozen and its logits kept;
- admission prefills each request alone (batch 1) through
  ``MultiModalLLM.prefill`` and copies it into its slot (quantising the new
  rows once under ``quantize_kv``).  The JAX package groups admissions in
  powers of two to bound its compiles; with batch-1 admission and
  row-independent decode kernels a request's bits do not depend on what
  shares the pool;
- the host reads one flag vector per chunk (``active & finished``), the
  static path's early-exit cadence.

Each request draws from its own CPU ``torch.Generator``
(``ops.sampling.process_and_sample_per_row``), so its tokens depend on its
prompt, its cap and its stream only, never on its slot, the pool size, the
chunk or co-batched traffic.  The speculative window mode (``window >= 2``)
and meshes are not ported yet and raise.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tsue_tpu_torch.ops.kv_quant import quantize_cache
from tsue_tpu_torch.ops.sampling import (SamplingConfig,
                                         process_and_sample_per_row)
from tsue_tpu_torch.utils.random import step_generator


@dataclass
class PoolState:
    """The whole slot pool's state on the device; every tensor leads with
    the slot axis."""
    caches: list               # per layer: (k, v) each (B, cache_len, Hkv,
                               # Dh) fp32, or (k8, ks, v8, vs) (quantize_kv)
    history: torch.Tensor      # (B, prompt_len + max_new) sampler history
    hlen: torch.Tensor         # (B,) valid history length
    logits: torch.Tensor       # (B, V) fp32 last logits per slot
    prefix_len: torch.Tensor   # (B,) fused prefix valid length
    fmask: torch.Tensor        # (B, P) fused prefix mask
    step: torch.Tensor         # (B,) decode step per slot
    out: torch.Tensor          # (B, max_new) generated tokens
    max_new: torch.Tensor      # (B,) per-request new-token cap
    active: torch.Tensor       # (B,) slot holds an unharvested request
    finished: torch.Tensor     # (B,) request done (EOS or cap)


class ContinuousBatcher:
    """Continuously batched decoding over a fixed pool of ``num_slots``
    slots, harvested every ``chunk`` ticks.  ``mllm`` is a
    ``MultiModalLLM``; with int8 tables attached (``ops.quant``) the decode
    steps use them, as the static generator does.  ``quantize_kv`` keeps the
    pool's caches in int8 (``ops.kv_quant``): admission prefills exactly in
    fp32 and quantises the new rows once on their way into the pool.  The
    fp32 cache holds the activations' dtype, as the port's static path
    does.  ``device``: the CUDA device by default, the CPU only when asked
    for; the MLLM must be on it."""

    def __init__(self, mllm, sampling: SamplingConfig, num_slots: int,
                 prompt_len: int, max_new_tokens: int, eos_id: int,
                 pad_id: int = 0, chunk: int = 8, window: int = 1,
                 quantize_kv: bool = False, device="cuda", mesh=None):
        if window < 1:
            raise ValueError("window must be >= 1")
        if window > 1:
            raise NotImplementedError(
                "the speculative window mode (window >= 2) is not ported "
                "yet (ROADMAP A: speculative decoding)")
        if mesh is not None:
            raise NotImplementedError("a mesh-sharded slot pool is not "
                                      "ported yet (ROADMAP A: parallel)")
        self.mllm = mllm
        self.sampling = sampling
        self.B = num_slots
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.chunk = max(1, min(chunk, max_new_tokens))
        self.quantize_kv = quantize_kv
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the batcher runs on the CUDA device by "
                               "default and none is available; pass "
                               "device='cpu' to run on the CPU")
        if next(mllm.parameters()).device.type != self.device.type:
            raise ValueError(f"the MLLM is not on the batcher's device "
                             f"{self.device}")
        n_img = mllm.qformer.cfg.num_query_tokens if mllm.use_vision else 0
        self.P = n_img + prompt_len
        self.cache_len = self.P + max_new_tokens
        self._hist_len = prompt_len + max_new_tokens
        self.last_run: Optional[Dict] = None

    def _init_state(self) -> PoolState:
        c = self.mllm.llama.cfg
        B, dev = self.B, self.device
        shape = (B, self.cache_len, c.num_kv_heads, c.head_dim)
        if self.quantize_kv:
            caches = [(torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.zeros(shape[:3], device=dev),
                       torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.zeros(shape[:3], device=dev))
                      for _ in range(c.num_layers)]
        else:
            caches = [(torch.zeros(shape, device=dev),
                       torch.zeros(shape, device=dev))
                      for _ in range(c.num_layers)]

        def full(shape, value, dtype=torch.int64):
            return torch.full(shape, value, dtype=dtype, device=dev)
        return PoolState(
            caches=caches,
            history=full((B, self._hist_len), self.pad_id),
            hlen=full((B,), 0),
            logits=full((B, c.vocab_size), 0.0, torch.float32),
            prefix_len=full((B,), 0, torch.int32),
            fmask=full((B, self.P), 0, torch.int32),
            step=full((B,), 0),
            out=full((B, self.max_new_tokens), self.pad_id),
            max_new=full((B,), 0),
            active=full((B,), False, torch.bool),
            finished=full((B,), False, torch.bool))

    def _admit(self, st: PoolState, slot: int, req: Dict, max_new: int):
        """Prefill one request (batch 1) and copy it into ``slot``."""
        dev = self.device
        vision = (torch.as_tensor(np.asarray(req["vision"], np.float32)
                                  )[None].to(dev)
                  if self.mllm.use_vision else None)
        ids = torch.as_tensor(np.asarray(req["prompt_ids"], np.int32)
                              )[None].to(dev)
        mask = torch.as_tensor(np.asarray(req["prompt_mask"], np.int32)
                               )[None].to(dev)
        caches, last_hidden, plen, fmask = self.mllm.prefill(
            vision, ids, mask, self.cache_len)
        logits0 = self.mllm.llama.logits_from_hidden(last_hidden,
                                                     quant_ok=True)
        if self.quantize_kv:
            caches = quantize_cache(caches)
        for layer, new in zip(st.caches, caches):
            for pool, rows in zip(layer, new):
                pool[slot] = rows[0]
        st.history[slot] = self.pad_id
        st.history[slot, :self.prompt_len] = ids[0]
        st.hlen[slot] = mask[0].sum()
        st.logits[slot] = logits0[0].float()
        st.prefix_len[slot] = plen[0]
        st.fmask[slot] = fmask[0]
        st.step[slot] = 0
        st.out[slot] = self.pad_id
        st.max_new[slot] = max_new
        st.active[slot] = True
        st.finished[slot] = False

    def _decode_chunk(self, st: PoolState,
                      generators: Sequence[Optional[torch.Generator]],
                      live_ticks: torch.Tensor) -> None:
        """``chunk`` ticks over the whole pool, in place (JAX
        ``_decode_chunk_impl``, ``serve_batching.py:230-265``); row b draws
        from ``generators[b]``.  ``live_ticks`` sums the live slots."""
        rows = torch.arange(self.B, device=self.device)
        pad = torch.full((self.B,), self.pad_id, dtype=torch.int64,
                         device=self.device)
        H = st.history.shape[1]
        for _ in range(self.chunk):
            live = st.active & ~st.finished
            tok = process_and_sample_per_row(st.logits, generators,
                                             st.history, st.hlen,
                                             self.sampling)
            tok = torch.where(live, tok, pad)
            oidx = st.step.clamp_max(self.max_new_tokens - 1)
            st.out[rows, oidx] = torch.where(live, tok, st.out[rows, oidx])
            hidx = st.hlen.clamp_max(H - 1)
            st.history[rows, hidx] = torch.where(live, tok,
                                                 st.history[rows, hidx])
            st.hlen += live
            st.finished |= live & ((tok == self.eos_id)
                                   | (st.step + 1 >= st.max_new))
            # finished and empty slots ride along: their step is frozen, so
            # they rewrite the same cache slot with masked-out rows.  A row
            # that stopped at its cap has step == max_new_tokens, one past
            # the cache (XLA drops such a write; here it is clamped onto the
            # row's own last slot, which no live step reads)
            logits = self.mllm.decode_step(
                tok, st.step.clamp_max(self.max_new_tokens - 1),
                st.prefix_len, st.caches, st.fmask, self.cache_len)
            st.logits = torch.where(live[:, None], logits.float(), st.logits)
            st.step += live
            live_ticks += live.sum()

    @torch.inference_mode()
    def run(self, requests: Sequence[Dict], seed: int = 0,
            refill: bool = True) -> List[np.ndarray]:
        """Decode all ``requests``; returns per-request int32 token arrays
        (EOS-trimmed), order-aligned with the input.

        Each request: {"prompt_ids": (P,) int, "prompt_mask": (P,) int
        [, "vision": (T, 512), "generator": a CPU torch.Generator,
        "max_new": int]}.  "vision" is required iff the model uses vision;
        "max_new" must lie in [0, max_new_tokens] (the pool's buffer size;
        raises otherwise, and 0 gives an empty result without taking a
        slot).  A request without a "generator" draws from
        ``utils.random.step_generator(seed, i)`` (i its index: the JAX
        package's ``fold_in(key(seed), i)``).

        ``refill=False`` schedules batch-synchronously (admit only when the
        whole pool has drained, the static generator's policy) with
        otherwise the same steps.

        ``self.last_run`` keeps the run's ticks, chunks, admissions, mean
        live slots per tick and, on a CUDA device, the admission prefills'
        and the decode chunks' device ms (CUDA events)."""
        results: Dict[int, np.ndarray] = {}
        queue: deque = deque()
        for rid, req in enumerate(requests):
            mn = int(req.get("max_new", self.max_new_tokens))
            if not 0 <= mn <= self.max_new_tokens:
                raise ValueError(
                    f"request {rid}: max_new={mn} outside "
                    f"[0, {self.max_new_tokens}] (the pool's buffer size)")
            if mn == 0:
                results[rid] = np.zeros((0,), np.int32)
            else:
                queue.append((rid, req, mn))
        if not queue:
            return [results[i] for i in range(len(requests))]
        cuda = self.device.type == "cuda"
        events = {"admit": [], "decode": []}

        def timed(what, fn, *args):
            if not cuda:
                return fn(*args)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(*args)
            ev[1].record()
            events[what].append(ev)

        st = self._init_state()
        live_ticks = torch.zeros((), dtype=torch.int64, device=self.device)
        slot_req: List[Optional[int]] = [None] * self.B
        gens: List[Optional[torch.Generator]] = [None] * self.B
        chunks = admissions = 0
        while queue or any(s is not None for s in slot_req):
            pool_empty = all(s is None for s in slot_req)
            free = ([] if not (refill or pool_empty)
                    else [s for s in range(self.B) if slot_req[s] is None])
            while free and queue:
                rid, req, mn = queue.popleft()
                s = free.pop()
                slot_req[s] = rid
                g = req.get("generator")
                gens[s] = g if g is not None else step_generator(seed, rid)
                timed("admit", self._admit, st, s, req, mn)
                admissions += 1
            timed("decode", self._decode_chunk, st, gens, live_ticks)
            chunks += 1
            harvest = (st.active & st.finished).cpu().numpy()
            if not harvest.any():
                continue
            out = st.out.cpu().numpy()
            steps = st.step.cpu().numpy()
            for s in np.nonzero(harvest)[0]:
                rid, slot_req[s], gens[s] = slot_req[s], None, None
                row = out[s, :steps[s]].astype(np.int32)
                eos = np.nonzero(row == self.eos_id)[0]
                results[rid] = row[:eos[0]] if eos.size else row
            st.active &= ~torch.from_numpy(harvest).to(self.device)
        ticks = chunks * self.chunk
        self.last_run = {
            "ticks": ticks, "chunks": chunks,
            "admissions": admissions,
            "mean_live_slots": int(live_ticks) / ticks}
        if cuda:
            for what, evs in events.items():
                self.last_run[f"{what}_ms"] = [a.elapsed_time(b)
                                               for a, b in evs]
        return [results[i] for i in range(len(requests))]
