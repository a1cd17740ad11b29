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
chunk or co-batched traffic.

Speculative window mode (``window >= 2``, ``tsue_tpu/serve_batching.py:
267-355``): each tick is one ``MultiModalLLM.decode_window`` forward over
all slots, the committed token and ``window - 1`` prompt-lookup drafts a
row (``eval.speculative.ngram_draft``), and each row keeps the longest
prefix its own sampler would have produced, so rows advance 1..W tokens a
tick on their own clocks.  Token position j of a request reads the j-th
block of uniforms its generator gives (``ops.sampling.uniform_widths``),
as the window-1 pool does one tick at a time: the host draws the blocks a
chunk can reach before the chunk and sends them in one copy, so a
request's ids equal the window-1 pool's.  The caches, the history and the
output buffer carry ``window`` slots of slack, so a finished or empty
row's window writes stay inside its own row.

Under a mesh (``tsue_tpu/serve_batching.py:88-118``) the pool is sharded
over data: each data rank holds ``num_slots / data`` slots and serves the
requests whose index it owns (round robin), with the model ranks of a
data rank running the same schedule on the local-shard MLLM; the results
are gathered on every rank in request order.  A request's ids do not
depend on its slot or pool, so they are the one-process pool's.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tsue_tpu_torch.eval.speculative import window_step
from tsue_tpu_torch.ops.kv_quant import quantize_cache
from tsue_tpu_torch.ops.sampling import (SamplingConfig, host_to_device,
                                         process_and_sample_per_row,
                                         row_uniform_blocks, uniform_widths)
from tsue_tpu_torch.parallel.sharding import grad_free
from tsue_tpu_torch.utils.random import step_generator


@dataclass
class PoolState:
    """The whole slot pool's state on the device; every tensor leads with
    the slot axis."""
    caches: list               # per layer: (k, v) each (B, cache_len, Hkv,
                               # Dh) fp32, or (k8, ks, v8, vs) (quantize_kv)
    history: torch.Tensor      # (B, prompt_len + max_new [+ W]) history
    hlen: torch.Tensor         # (B,) valid history length
    logits: torch.Tensor       # (B, V) fp32 last logits per slot
    prefix_len: torch.Tensor   # (B,) fused prefix valid length
    fmask: torch.Tensor        # (B, P) fused prefix mask
    step: torch.Tensor         # (B,) decode step per slot
    out: torch.Tensor          # (B, max_new [+ W]) generated tokens
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
    does.  ``window``: 1 decodes a token a tick; >= 2 is the speculative
    window mode (module docstring), ``draft_ngram`` the n of its suffix
    lookup; a request's ids are the window-1 pool's.  ``device``: the CUDA
    device by default, the CPU only when asked for; the MLLM must be on
    it."""

    def __init__(self, mllm, sampling: SamplingConfig, num_slots: int,
                 prompt_len: int, max_new_tokens: int, eos_id: int,
                 pad_id: int = 0, chunk: int = 8, window: int = 1,
                 draft_ngram: int = 3, quantize_kv: bool = False,
                 device="cuda", mesh=None):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.mesh = mesh
        if mesh is not None:
            if num_slots % mesh.data:
                raise ValueError(
                    f"num_slots={num_slots} must divide the mesh's data axis "
                    f"({mesh.data}): the pool shards slot-major over data")
            num_slots //= mesh.data
        self.mllm = mllm
        self.sampling = sampling
        self.B = num_slots
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.chunk = max(1, min(chunk, max_new_tokens))
        self.window = window
        self.draft_ngram = draft_ngram
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
        # a window's writes reach W - 1 slots past the nominal lengths
        slack = window if window > 1 else 0
        self.cache_len = self.P + max_new_tokens + slack
        self._hist_len = prompt_len + max_new_tokens + slack
        self._out_len = max_new_tokens + slack
        self._widths = uniform_widths(sampling, mllm.llama.cfg.vocab_size)
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
            out=full((B, self._out_len), self.pad_id),
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

    def _chunk_uniforms(self, blocks: List[Optional[torch.Tensor]],
                        generators: Sequence[Optional[torch.Generator]],
                        steps: np.ndarray, caps: Sequence[int]):
        """The (B, chunk * W, n) uniforms a window chunk can read: row b's
        blocks for output positions steps[b] .. steps[b] + chunk * W - 1
        (a tick advances a row by at most W), drawn on the host from
        ``generators[b]`` as far as the request's cap and kept in
        ``blocks[b]``, so that position j reads the generator's j-th block
        however many ticks reach it; positions past the cap repeat the
        last block (they are never emitted).  None when greedy."""
        if not self._widths:
            return None
        width = self.chunk * self.window
        n = sum(self._widths)
        table = torch.full((self.B, width, n), 0.5)
        for b, g in enumerate(generators):
            if g is None:
                continue
            need = min(int(caps[b]), int(steps[b]) + width) - (
                0 if blocks[b] is None else blocks[b].shape[0])
            if need > 0:
                new = row_uniform_blocks([g], self._widths, need, "cpu")[0]
                blocks[b] = new if blocks[b] is None else torch.cat(
                    [blocks[b], new])
            pos = torch.arange(width) + int(steps[b])
            table[b] = blocks[b][pos.clamp_max(blocks[b].shape[0] - 1)]
        return host_to_device(table, self.device)

    def _decode_chunk_window(self, st: PoolState,
                             u: Optional[torch.Tensor],
                             live_ticks: torch.Tensor) -> None:
        """``chunk`` speculative ticks over the whole pool, in place (JAX
        ``_decode_chunk_window``, ``serve_batching.py:267-355``): draw the
        committed token at every row's step from its block (the window-1
        tick's draw), propose W - 1 drafts, score the window in one
        ``decode_window`` forward, and accept drafts while they equal the
        row's own draw at their position.  ``u``: the chunk's uniforms
        (``_chunk_uniforms``), indexed from each row's step at the chunk's
        start."""
        rows = torch.arange(self.B, device=self.device)[:, None]
        offs = torch.arange(self.window, device=self.device)[None, :]
        step0 = st.step.clone()
        for _ in range(self.chunk):
            live = st.active & ~st.finished
            uw = None if u is None else u[rows, (st.step - step0)[:, None]
                                          + offs]
            # a finished or empty row's step is frozen at most at its cap,
            # so its window writes land inside the row's own W slots of
            # slack
            st.logits, eos_hit = window_step(
                self.mllm, self.sampling, self.draft_ngram, st.logits, uw,
                live, st.step, st.hlen, st.history, st.out, st.caches,
                st.prefix_len, st.fmask, self.cache_len, st.max_new,
                self.window, self.eos_id, self.pad_id)
            st.finished |= eos_hit | (live & (st.step >= st.max_new))
            live_ticks += live.sum()

    @grad_free("mllm")
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
        and the decode chunks' device ms (CUDA events).

        Under a mesh every rank passes the same ``requests``; the data
        rank serves every ``data``-th one from its own index, and the
        results are gathered whole (``last_run`` is the rank's pool's)."""
        if self.mesh is not None and self.mesh.data > 1:
            from tsue_tpu_torch.parallel.mesh import all_gather_object
            m = self.mesh
            mine = list(range(m.data_rank, len(requests), m.data))
            reqs = []
            for i in mine:
                r = dict(requests[i])
                if r.get("generator") is None:
                    r["generator"] = step_generator(seed, i)
                reqs.append(r)
            local = self._run(reqs, seed, refill)
            out: List[Optional[np.ndarray]] = [None] * len(requests)
            for idx, rows in all_gather_object((mine, local), m.data_group):
                for i, row in zip(idx, rows):
                    out[i] = row
            return out
        return self._run(requests, seed, refill)

    def _run(self, requests: Sequence[Dict], seed: int, refill: bool
             ) -> List[np.ndarray]:
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
        # window mode: each slot's drawn uniform blocks, its step and cap
        blocks: List[Optional[torch.Tensor]] = [None] * self.B
        steps = np.zeros(self.B, np.int64)
        caps = [0] * self.B
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
                blocks[s], steps[s], caps[s] = None, 0, mn
                timed("admit", self._admit, st, s, req, mn)
                admissions += 1
            if self.window > 1:
                u = self._chunk_uniforms(blocks, gens, steps, caps)
                timed("decode", self._decode_chunk_window, st, u,
                      live_ticks)
            else:
                timed("decode", self._decode_chunk, st, gens, live_ticks)
            chunks += 1
            # one read of the device a chunk: the harvest flags and steps
            flags = torch.stack([(st.active & st.finished).long(),
                                 st.step]).cpu().numpy()
            harvest, steps = flags[0] > 0, flags[1]
            if not harvest.any():
                continue
            out = st.out.cpu().numpy()
            for s in np.nonzero(harvest)[0]:
                rid, slot_req[s], gens[s] = slot_req[s], None, None
                blocks[s] = None
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
