"""Llama-3.2-style decoder stack with LoRA.

Counterpart of ``tsue_tpu/models/llama.py``.  What is carried: RMSNorm
(through ``ops.fused.fused_rmsnorm`` when the ``TSUE_FUSED`` switch is on),
llama-3 rope scaling, ``LoRADense`` (LoRA dropout, the int8 decode branch of
``ops/quant.py`` and the MLP's fused SwiGLU down-projection of
``ops/fused.py``), the attention / MLP / layer / model classes with the KV
cache (fp32 or bf16, or the int8 cache of ``ops/kv_quant.py``), the
tied-embedding layout, ``logits_from_hidden`` and the causal-LM loss, dense
or in sequence chunks that never hold the (B, T, V) logits, and per-layer remat
(``LlamaConfig.remat``: ``torch.utils.checkpoint`` with the JAX package's
three policies).  Dropout (LoRA) draws from the ``generator`` a training
forward passes, and only then; a rematerialised layer's recompute replays
the generator from the state it had at the layer's entry, so it draws the
masks its forward drew (JAX's ``nn.remat`` replays its key).

Tensor parallelism (a ``parallel.mesh.Mesh`` with ``model > 1``): the
model is this rank's local shard, built from ``local_config`` (the heads,
KV heads and FFN width divided by the model degree) with the shapes
``parallel.sharding.shard_state`` cuts.  q/k/v and gate/up are split by
columns, behind ``copy_to_model`` (identity forward, all-reduce backward);
o and down by rows, followed by ``reduce_from_model`` (all-reduce forward,
identity backward).  A column-split projection's LoRA keeps A whole and B
split, a copy between them; a row-split one splits A and reduces before
the whole B.  The embedding table is split on the feature dim and its
lookups gathered whole (``gather_from_model``); the tied head takes this
rank's feature slice of the hidden states and reduces the partial logits.
The kernels see plain local tensors.

Pipeline parallelism (``parallel.pipeline``): a stage's model holds only
its own decoder layers (``layers``), under their global names
(``layer_{i}``), beside the whole outer part (embedding, final norm,
head).

KV caches are lists of per-layer tensors written in place (the JAX package
returns new ones).  An fp32 layer is ``(k, v)``, each (B, S, Hkv, Dh); an
int8 layer is ``(k8, ks, v8, vs)``.  Keys are roped before they are
written.

Compute dtype.  Parameters keep the dtype they hold, and every product and
sum yields the dtype jnp's promotion gives (fp32 if an operand is fp32).
Where the JAX package casts a weight to the compute dtype (``LoRADense``:
``jnp.dot(x, kernel.astype(dtype), preferred_element_type=f32)
.astype(x.dtype)``), the port rounds the weight to ``dtype`` and multiplies
in the promoted dtype with fp32 sums, returning x's dtype.  So:

- fp32 parameters under the "bfloat16" configuration (what ``Predictor``
  serves) run fp32 activations against bf16-rounded weights, since the
  embedding, and so every activation, is fp32;
- parameters cast to bf16 (``utils.precision.cast_params``, as the runner
  builds a "bfloat16" configuration for training) make the embedding bf16,
  and with it the residual stream, the projections and the attention's
  operands; the norms' statistics, the softmax, the rope and the losses
  stay fp32, and the logits are fp32.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from tsue_tpu_torch.config import LlamaConfig
from tsue_tpu_torch.ops.attention import dot_product_attention
from tsue_tpu_torch.ops.flash import rope_bthd
from tsue_tpu_torch.ops.fused import (fused_enabled, fused_rmsnorm,
                                      rmsnorm_plain, swiglu_matmul)
from tsue_tpu_torch.ops.kv_quant import (attend_int8_kv, update_kv_int8,
                                         write_rows)
from tsue_tpu_torch.ops.quant import int8_matmul
from tsue_tpu_torch.parallel.mesh import (copy_to_model, gather_from_model,
                                          reduce_from_model)
from tsue_tpu_torch.parallel.sharding import unsharded
from tsue_tpu_torch.utils.precision import promote
from tsue_tpu_torch.utils.random import dropout

# the outputs each policy saves (jax.checkpoint_policies.checkpoint_dots and
# dots_with_no_batch_dims_saveable): every matrix product, or the 2-D ones
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)
_DOTS_NO_BATCH = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_ops_policy(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(name: Optional[str]):
    """``LlamaConfig.remat_policy`` -> the checkpoint's ``context_fn``, or
    None for "full" (recompute the whole layer in the backward: least
    memory, one more forward).  "dots" saves every matrix product's output,
    "dots_no_batch" the 2-D ones, so the backward recomputes only the rest
    (``tsue_tpu/models/llama.py:35-51``)."""
    if name in ("full", "", None):
        return None
    if name == "dots":
        ops = _DOTS
    elif name == "dots_no_batch":
        ops = _DOTS_NO_BATCH
    else:
        raise ValueError(f"unknown remat_policy {name!r} "
                         "(expected full|dots|dots_no_batch)")
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_save_ops_policy, ops))


def _replay(generator: Optional[torch.Generator]):
    """A function that returns ``generator`` on its first call and, on
    every later one (the backward's recompute), a new generator started
    from the state ``generator`` has now."""
    if generator is None:
        return lambda: None
    state = generator.get_state()
    calls = []

    def gen():
        if not calls:
            calls.append(1)
            return generator
        g = torch.Generator(device=generator.device)
        g.set_state(state)
        return g
    return gen


class RMSNorm(nn.Module):
    """fp32 statistics, scale, cast back; the one-pass kernel when the fused
    switch is on (``tsue_tpu/models/llama.py:55-67``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if fused_enabled():
            return fused_rmsnorm(x, self.scale, self.eps)
        return rmsnorm_plain(x, self.scale, self.eps)


def rope_inv_freq(cfg: LlamaConfig) -> np.ndarray:
    """Inverse frequencies with llama-3-style long-context scaling (the
    numpy math of ``tsue_tpu.models.llama.rope_inv_freq``)."""
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2,
                                              dtype=np.float64) / cfg.head_dim))
    if cfg.rope_scaling_factor and cfg.rope_scaling_factor != 1.0:
        low_wl = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high_wl = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wl = 2 * np.pi / inv
        # three bands: long wavelengths scaled down, short kept, mid smoothed
        smooth = ((cfg.rope_original_max_position / wl)
                  - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        smooth = np.clip(smooth, 0.0, 1.0)
        scaled = inv / cfg.rope_scaling_factor
        blended = (1 - smooth) * scaled + smooth * inv
        inv = np.where(wl > low_wl, scaled,
                       np.where(wl < high_wl, inv, blended))
    return inv.astype(np.float32)


class LoRADense(nn.Module):
    """Dense with an optional additive low-rank adapter, Flax layout:
    ``kernel`` (in, out), ``lora_a`` (in, r), ``lora_b`` (r, out).

    y = x @ W + (alpha / r) * (dropout(x) @ A) @ B, each weight rounded to
    ``dtype``; x @ W in the promoted dtype with fp32 sums, returned in x's
    dtype, and the adapter's products in their promoted dtypes
    (``tsue_tpu/models/llama.py:148-162``); the LoRA dropout draws from
    ``generator`` and is the identity without one.

    With int8 tables attached (``ops.quant.attach_quant``: buffers ``w8``
    (in, out) and ``scale`` (out,)) a call with ``quant_ok=True`` takes
    ``x @ W`` from ``int8_matmul`` instead; the LoRA delta is still added
    after it (``tsue_tpu/models/llama.py:139-162``).

    ``swiglu_up`` makes it the MLP's down-projection: x is the gate and the
    input is ``silu(x) * swiglu_up``.  With the fused switch on, no int8
    decode call and no adapter, ``ops.fused.swiglu_matmul`` forms that
    product inside its kernel (the JAX precedence, ``llama.py:125-138``;
    the port's LoRADense has no bias)."""

    def __init__(self, in_features: int, features: int, lora_r: int = 0,
                 lora_alpha: float = 32.0, lora_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, split: str = "",
                 mesh=None):
        super().__init__()
        self.dtype = dtype
        # "col" or "row" under tensor parallelism (module docstring)
        self.split = split if mesh is not None and mesh.model > 1 else ""
        self.mesh = mesh
        self.lora_r = lora_r
        self.lora_alpha = lora_alpha
        self.lora_dropout = lora_dropout
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        if lora_r > 0:
            self.lora_a = nn.Parameter(torch.empty(in_features, lora_r))
            self.lora_b = nn.Parameter(torch.zeros(lora_r, features))
        self.register_buffer("w8", None, persistent=False)
        self.register_buffer("scale", None, persistent=False)

    def _w(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The weight rounded to ``dtype``, in its promoted dtype with x."""
        w = w.to(self.dtype)
        return w.to(promote(x, w))

    def _dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w.to(dtype) in the promoted dtype (``jnp.dot``)."""
        w = self._w(w, x)
        return x.to(w.dtype) @ w

    def forward(self, x: torch.Tensor, quant_ok: bool = False,
                swiglu_up: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        decode_quant = quant_ok and self.w8 is not None
        col, row = self.split == "col", self.split == "row"
        if swiglu_up is not None:
            if not decode_quant and fused_enabled() and self.lora_r == 0:
                y = swiglu_matmul(x, swiglu_up, self._w(self.kernel, x))
                return reduce_from_model(y, self.mesh) if row else y
            x = F.silu(x) * swiglu_up
        xm = copy_to_model(x, self.mesh) if col else x
        if decode_quant:
            y = int8_matmul(xm, self.w8, self.scale)
        else:
            y = self._dot(xm, self.kernel).to(x.dtype)
        if row:
            y = reduce_from_model(y, self.mesh)
        if self.lora_r > 0:
            h = dropout(x, self.lora_dropout, generator)
            z = self._dot(h, self.lora_a)
            if col:
                z = copy_to_model(z, self.mesh)
            elif row:
                z = reduce_from_model(z, self.mesh)
            delta = self._dot(z, self.lora_b)
            y = y + (self.lora_alpha / self.lora_r) * delta.to(y.dtype)
        return y


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype = torch.float32,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        lr = c.lora_r if c.use_lora else 0

        def dense(name, out):
            return LoRADense(c.hidden_size if name != "o_proj"
                             else c.num_heads * c.head_dim, out,
                             lora_r=lr if name in c.lora_targets else 0,
                             lora_alpha=c.lora_alpha,
                             lora_dropout=c.lora_dropout, dtype=dtype,
                             split="row" if name == "o_proj" else "col",
                             mesh=mesh)
        self.q_proj = dense("q_proj", c.num_heads * c.head_dim)
        self.k_proj = dense("k_proj", c.num_kv_heads * c.head_dim)
        self.v_proj = dense("v_proj", c.num_kv_heads * c.head_dim)
        self.o_proj = dense("o_proj", c.hidden_size)

    def forward(self, x, mask, rope, kv_cache=None, cache_index=None,
                kv_mask=None, quant_ok=False, generator=None):
        """Without a cache: causal self-attention over x, ``mask`` (B, T)
        key validity, the rope applied in the kernel.

        With a cache, q and k are roped first and the new k/v rows are
        written at ``cache_index``, an int or (B,) per-row slots
        (continuous batching, ``tsue_tpu/models/llama.py:214-227``).
        Prefill form (``kv_mask`` is
        None): the rows are the whole valid cache (``cache_index`` 0), so
        attention runs over the new keys themselves, causally with the
        (B, T) ``mask`` — the JAX package's (B, 1, T, S) prefill mask
        (``tsue_tpu/models/fusion.py:109-117``) is that function, since
        the slots past T are masked.  Decode form: attention runs over the
        whole cache, not causal, with ``kv_mask`` (B, S) key validity or a
        per-query (B, T, S) mask (a T-wide speculative window, each row
        writing T consecutive slots from its own, ``tsue_tpu/models/
        llama.py:208-229``); an int8 cache goes to ``attend_int8_kv``."""
        c = self.cfg
        B, T, _ = x.shape
        q = self.q_proj(x, quant_ok, generator=generator).reshape(
            B, T, c.num_heads, c.head_dim)
        k = self.k_proj(x, quant_ok, generator=generator).reshape(
            B, T, c.num_kv_heads, c.head_dim)
        v = self.v_proj(x, quant_ok, generator=generator).reshape(
            B, T, c.num_kv_heads, c.head_dim)
        if kv_cache is None:
            # the rope goes to the attention op, which applies it in the
            # kernel
            out = dot_product_attention(q, k, v, mask=mask, is_causal=True,
                                        rope=rope)
        else:
            q = rope_bthd(q, *rope)
            k = rope_bthd(k, *rope)
            if len(kv_cache) == 4:
                if kv_mask is None:
                    raise ValueError("an int8 cache is for decode only: "
                                     "prefill into fp32 and quantise")
                update_kv_int8(kv_cache, k, v, cache_index)
                out = attend_int8_kv(q, kv_cache, kv_mask)
            else:
                ck, cv = kv_cache
                write_rows(ck, k, cache_index)
                write_rows(cv, v, cache_index)
                if kv_mask is None:
                    if not isinstance(cache_index, int) or cache_index != 0:
                        raise ValueError("prefill writes from slot 0")
                    out = dot_product_attention(q, k, v, mask=mask,
                                                is_causal=True)
                else:
                    out = dot_product_attention(q, ck, cv, mask=kv_mask,
                                                is_causal=False)
        return self.o_proj(out.reshape(B, T, c.num_heads * c.head_dim),
                           quant_ok, generator=generator)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype = torch.float32,
                 mesh=None):
        super().__init__()
        c = cfg
        self.gate_proj = LoRADense(c.hidden_size, c.intermediate_size,
                                   dtype=dtype, split="col", mesh=mesh)
        self.up_proj = LoRADense(c.hidden_size, c.intermediate_size,
                                 dtype=dtype, split="col", mesh=mesh)
        self.down_proj = LoRADense(c.intermediate_size, c.hidden_size,
                                   dtype=dtype, split="row", mesh=mesh)

    def forward(self, x, quant_ok=False):
        return self.down_proj(self.gate_proj(x, quant_ok), quant_ok,
                              swiglu_up=self.up_proj(x, quant_ok))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype = torch.float32,
                 mesh=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = LlamaAttention(cfg, dtype, mesh)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg, dtype, mesh)

    def forward(self, x, mask, rope, kv_cache=None, cache_index=None,
                kv_mask=None, quant_ok=False, generator=None):
        x = x + self.attn(self.input_norm(x), mask, rope, kv_cache,
                          cache_index, kv_mask, quant_ok, generator)
        return x + self.mlp(self.post_attn_norm(x), quant_ok)


class LlamaModel(nn.Module):
    """Decoder stack over input embeddings (the fusion prepends image
    tokens at the embedding level).  ``layers``: the indices of the
    decoder layers this model holds (a pipeline stage's), all of them by
    default."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype = torch.float32,
                 mesh=None, layers: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        tp = mesh.model if mesh is not None else 1
        # under TP, this rank's slice of the feature dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size,
                                         cfg.hidden_size // tp)
        self.layer_ids = list(range(cfg.num_layers) if layers is None
                              else layers)
        for i in self.layer_ids:
            self.add_module(f"layer_{i}", LlamaLayer(cfg, dtype, mesh))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        # the policy's name is checked here, as nn.remat checks it at setup
        self._remat_ctx = remat_policy(cfg.remat_policy) if cfg.remat \
            else None
        self.register_buffer("inv_freq",
                             torch.as_tensor(rope_inv_freq(cfg)),
                             persistent=False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return gather_from_model(self.embed_tokens(input_ids), self.mesh)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                kv_caches: Optional[List] = None, cache_index=0,
                kv_mask: Optional[torch.Tensor] = None,
                quant_ok: bool = False,
                generator: Optional[torch.Generator] = None,
                normed: bool = True) -> torch.Tensor:
        """inputs_embeds (B, T, D); attention_mask (B, T), 1 = real token.
        Returns the final-normed hidden states (B, T, D) (``normed=False``:
        the last layer's output, as a pipeline stage hands it on).

        ``kv_caches`` (per layer, see the module docstring) are written in
        place at ``cache_index`` (an int, or (B,) per-row slots): without ``kv_mask`` this is the prefill
        (the T rows are the whole valid cache), with ``kv_mask`` a decode
        step over the whole cache: (B, S), or (B, T, S) per query for a
        T-wide window.  ``positions`` (B, T) default to
        the cumulative count of ``attention_mask`` (or 0..T-1).
        ``quant_ok=True`` (decode only) lets the projections use attached
        int8 tables.  ``generator``: the LoRA dropout's draws (training).

        With ``cfg.remat``, a forward that autograd records and that has no
        cache runs each layer under ``torch.utils.checkpoint`` (not
        reentrant): its activations are recomputed in the backward, the
        policy's saved products aside, with the generator replayed from the
        layer's entry; decode and no-grad calls run as without remat."""
        B, T, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        mask = None
        if attention_mask is not None:
            mask = attention_mask.bool()
        if positions is None:
            if attention_mask is not None:
                positions = (attention_mask.long().cumsum(1) - 1).clamp_min(0)
            else:
                positions = torch.arange(T, device=dev).expand(B, T)
        angles = positions[..., None].float() * self.inv_freq   # (B, T, D/2)
        rope = (torch.cos(angles), torch.sin(angles))
        x = inputs_embeds
        remat = (self.cfg.remat and kv_caches is None
                 and torch.is_grad_enabled())
        for j, i in enumerate(self.layer_ids):
            layer = getattr(self, f"layer_{i}")
            if remat:
                x = self._checkpointed(layer, x, mask, rope, generator)
                continue
            cache = None if kv_caches is None else kv_caches[j]
            x = layer(x, mask, rope, cache, cache_index, kv_mask, quant_ok,
                      generator)
        return self.final_norm(x) if normed else x

    def _checkpointed(self, layer, x, mask, rope, generator):
        gen = _replay(generator)
        kw = {} if self._remat_ctx is None else {
            "context_fn": self._remat_ctx}
        # every draw comes from the explicit generator: the global RNG
        # state needs no stashing
        return checkpoint(
            lambda x_: layer(x_, mask, rope, generator=gen()), x,
            use_reentrant=False, preserve_rng_state=False, **kw)


IGNORE_LABEL = -100


class LlamaForCausalLM(nn.Module):
    """LlamaModel with its (tied, by default) LM head.  The forward returns
    the hidden states, and the logits and the causal-LM loss when asked
    (stage 1); ``logits_from_hidden`` applies the head (decode).
    With int8 tables attached (buffers ``lm_head_w8`` (D, V) and
    ``lm_head_scale`` (V,)), decode calls (``quant_ok=True``) stream them
    through ``int8_matmul``."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype = torch.float32,
                 mesh=None, layers: Optional[Sequence[int]] = None):
        super().__init__()
        cfg = local_config(cfg, mesh)
        self.cfg = cfg
        self.dtype = dtype
        self.mesh = mesh
        self.model = LlamaModel(cfg, dtype, mesh, layers)
        if not cfg.tie_word_embeddings:
            from tsue_tpu_torch.models.layers import Dense
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.register_buffer("lm_head_w8", None, persistent=False)
        self.register_buffer("lm_head_scale", None, persistent=False)
        # the fused head's whole table under TP (``parallel.serve_tp``)
        self.head_table = None

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed(input_ids)

    def head_weight(self) -> torch.Tensor:
        """The (V, D) head weight, in the parameters' dtype: the tied
        embedding or the untied head."""
        if self.cfg.tie_word_embeddings:
            return self.model.embed_tokens.weight
        return self.lm_head.weight

    def logits_from_hidden(self, hidden: torch.Tensor,
                           quant_ok: bool = False) -> torch.Tensor:
        """(..., D) -> (..., V) fp32 logits.  The tied head rounds the
        embedding to the compute dtype and sums in fp32, as the JAX package
        does (``llama.py:385-388``); the untied head is a Dense, its output
        taken to fp32."""
        if quant_ok and self.lm_head_w8 is not None:
            return reduce_from_model(int8_matmul(
                self._feature_slice(hidden), self.lm_head_w8,
                self.lm_head_scale, out_dtype=torch.float32), self.mesh)
        if self.cfg.tie_word_embeddings:
            emb = self.model.embed_tokens
            with unsharded(emb):
                return self._tied_logits(hidden, emb.weight)
        return self.lm_head(hidden).float()

    def _feature_slice(self, hidden: torch.Tensor) -> torch.Tensor:
        """Under TP, this rank's slice of the (whole) hidden states' feature
        dim, behind a copy (its gradient is this slice's part alone)."""
        m = self.mesh
        if m is None or m.model == 1:
            return hidden
        return copy_to_model(hidden, m).chunk(m.model, -1)[m.model_rank]

    def _tied_logits(self, hidden: torch.Tensor, w: torch.Tensor
                     ) -> torch.Tensor:
        """fp32 logits of the tied head (``w`` the (V, D) table, under TP
        its feature slice): a reduce of the partial products."""
        h = self._feature_slice(hidden)
        return reduce_from_model(h.float() @ w.to(self.dtype).float().t(),
                                 self.mesh)

    def forward(self, inputs_embeds, attention_mask=None, labels=None,
                generator=None, compute_logits: bool = False
                ) -> Dict[str, torch.Tensor]:
        """{"hidden"} and, when asked, "logits" (B, T, V) fp32 and "loss",
        with the JAX package's precedence (``llama.py:402-425``): labels
        with ``cfg.loss_chunk`` and no ``compute_logits`` take the chunked
        loss (no logits); otherwise ``compute_logits`` or labels form the
        logits, and labels the dense loss over them.  Stage 2 asks for
        neither: the hidden states are all it needs."""
        hidden = self.model(inputs_embeds, attention_mask,
                            generator=generator)
        out = {"hidden": hidden}
        if labels is not None and self.cfg.loss_chunk and not compute_logits:
            s, n = self.ce_sum(hidden, labels)
            out["loss"] = s / n.clamp_min(1)
        elif compute_logits or labels is not None:
            out["logits"] = self.logits_from_hidden(hidden)
            if labels is not None:
                out["loss"] = causal_lm_loss(out["logits"], labels)
        return out

    def ce_sum(self, hidden: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(CE sum, valid-token count) of the next-token loss over the
        final-normed ``hidden``: in chunks with ``cfg.loss_chunk`` (no
        (B, T, V) logits), else over the dense logits."""
        if not self.cfg.loss_chunk:
            return causal_lm_ce_sum(self.logits_from_hidden(hidden), labels)
        w = self.head_weight().to(self.dtype).float()
        if self.mesh is not None and self.mesh.model > 1:
            if not self.cfg.tie_word_embeddings:
                raise NotImplementedError("the chunked loss under TP "
                                          "takes the tied head")
            fn = self._tied_logits
        else:
            fn = lambda h, w_: h.float() @ w_.t()   # noqa: E731
        return causal_lm_ce_sum_chunked(hidden, labels, fn,
                                        self.cfg.loss_chunk, w)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Next-token cross entropy with -100 ignored (HF semantics): the mean
    over the valid shifted tokens (0 when there are none)."""
    s, n = causal_lm_ce_sum(logits, labels)
    return s / n.clamp_min(1)


def causal_lm_ce_sum(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(CE sum, valid-token count) of :func:`causal_lm_loss`."""
    V = logits.shape[-1]
    shift = logits[:, :-1].float().reshape(-1, V)
    y = labels[:, 1:].reshape(-1).long()
    return (F.cross_entropy(shift, y, ignore_index=IGNORE_LABEL,
                            reduction="sum"), (y != IGNORE_LABEL).sum())


def causal_lm_loss_chunked(hidden: torch.Tensor, labels: torch.Tensor,
                           logits_fn: Callable, chunk: int,
                           weight: torch.Tensor) -> torch.Tensor:
    """``causal_lm_loss`` without ever holding the (B, T, V) logits: the
    head product and the cross entropy run per sequence chunk, and the
    backward recomputes each chunk's logits (``torch.utils.checkpoint``)
    instead of saving them, so the logits' memory is O(B * chunk * V).
    ``logits_fn(h, weight)`` maps (B, chunk, D) hidden states to fp32
    logits; ``weight`` is passed through so that its gradient flows."""
    s, n = causal_lm_ce_sum_chunked(hidden, labels, logits_fn, chunk, weight)
    return s / n.clamp_min(1)


def _chunk_ce(h, y, weight, logits_fn):
    logits = logits_fn(h, weight).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1), ignore_index=IGNORE_LABEL,
                           reduction="sum")


def causal_lm_ce_sum_chunked(hidden: torch.Tensor, labels: torch.Tensor,
                             logits_fn: Callable, chunk: int,
                             weight: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(CE sum, valid-token count) of :func:`causal_lm_loss_chunked`: the
    shifted sequence is padded to a multiple of ``chunk`` with -100 labels
    (``tsue_tpu/models/llama.py:457-491``)."""
    B, T, D = hidden.shape
    h = hidden[:, :-1]
    y = labels[:, 1:].long()
    pad = (-(T - 1)) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad), value=IGNORE_LABEL)
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, h.shape[1], chunk):
        total = total + checkpoint(_chunk_ce, h[:, i:i + chunk],
                                   y[:, i:i + chunk], weight, logits_fn,
                                   use_reentrant=False)
    return total, (y != IGNORE_LABEL).sum()


def local_config(cfg: LlamaConfig, mesh) -> LlamaConfig:
    """The Llama config of one model rank's shard: heads, KV heads and FFN
    width divided by the model degree (hidden width and vocabulary whole).
    Raises where the degree does not divide them."""
    if mesh is None or mesh.model == 1:
        return cfg
    import dataclasses
    from tsue_tpu_torch.parallel.sharding import check_tensor_parallel
    check_tensor_parallel(cfg, mesh)
    tp = mesh.model
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32,
                  device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer (k, v) zero buffers of shape (B, max_len, Hkv, Dh)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_layers)]
