"""Import the reference's own PyTorch checkpoints into the port.

Counterpart of ``tsue_tpu/models/torch_import.py``, in numpy and torch.
The stage-1 artifact ``mllm_lora_ddp_finetuned.pt`` (consumed at ref
scripts/train.py:1137 with strict=True) is a ``state_dict`` of the
reference's ``LlamaMultiModal``:

  qformer.vision_proj.{weight,bias}
  qformer.encoder.layers.{i}.self_attn.in_proj_{weight,bias}   (packed qkv)
  qformer.encoder.layers.{i}.self_attn.out_proj.{weight,bias}
  qformer.encoder.layers.{i}.linear1/linear2, norm1/norm2
  qformer.query_tokens
  qformer.decoder.layers.{i}.self_attn / multihead_attn / linear1/2 /
                              norm1/norm2/norm3
  q_proj.{weight,bias}
  vision_modality_embedding / text_modality_embedding
  llama_wrapper.llama_model.[base_model.model.]model.layers.{i}...
      with PEFT names: q_proj.base_layer.weight, q_proj.lora_A.default.weight
      (r, in), q_proj.lora_B.default.weight (out, r)

and the stage-2 artifact (ref scripts/train.py:1219-1224) the whole
``MultiModalTrajectoryModel``: ``lane_polygon_encoder.*``, ``mllm.*`` (the
layout above) and ``ltsf.*``.

Each ``convert_*`` returns the Flax-path tree of fp32 numpy arrays that
``convert.load_flax_params`` fills the port's module from, strictly (the
port names its submodules after the Flax paths).  The trees equal the JAX
package's leaf for leaf and bit for bit.  LoRA: lora_a = lora_A.T (in, r),
lora_b = lora_B.T (r, out).  The Llama goes through the port's own
``models.llama_loader.convert_hf_state_dict``.

``consumed`` (a set) collects every checkpoint key a conversion read;
``check_consumed`` raises on the rest.  A tied ``lm_head.weight`` (torch
keeps tied weights under both names) counts as read; an untied one raises
``ValueError`` (the JAX package drops it and leaves it to its audit).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tsue_tpu_torch.convert import _flatten, _unflatten


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


class _KeyRecorder(dict):
    """A dict that records every key read into ``consumed``, mapped back
    through ``origin`` to the checkpoint's own key names."""

    def __init__(self, data, consumed: set, origin=None):
        super().__init__(data)
        self._consumed = consumed
        self._origin = origin or {}

    def __getitem__(self, k):
        self._consumed.add(self._origin.get(k, k))
        return super().__getitem__(k)


def _j(prefix: str, rest: str) -> str:
    return f"{prefix}.{rest}" if prefix else rest


def _mha(sd: Mapping, prefix: str, d_model: int, num_heads: int) -> Dict:
    """torch nn.MultiheadAttention -> MHA (q/k/v/o DenseGeneral)."""
    dh = d_model // num_heads
    out = {}
    w = _np(sd[_j(prefix, "in_proj_weight")])          # (3d, d)
    b = _np(sd[_j(prefix, "in_proj_bias")])            # (3d,)
    for i, name in enumerate(("q", "k", "v")):
        wi = w[i * d_model:(i + 1) * d_model]          # (d_out, d_in)
        bi = b[i * d_model:(i + 1) * d_model]
        out[name] = {"kernel": wi.T.reshape(d_model, num_heads, dh),
                     "bias": bi.reshape(num_heads, dh)}
    wo = _np(sd[_j(prefix, "out_proj.weight")])        # (d, d)
    bo = _np(sd[_j(prefix, "out_proj.bias")])
    out["o"] = {"kernel": wo.T.reshape(num_heads, dh, d_model), "bias": bo}
    return out


def _linear(sd: Mapping, prefix: str) -> Dict:
    out = {"kernel": _np(sd[_j(prefix, "weight")]).T}
    if _j(prefix, "bias") in sd:
        out["bias"] = _np(sd[_j(prefix, "bias")])
    return out


def _norm(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _np(sd[_j(prefix, "weight")]),
            "bias": _np(sd[_j(prefix, "bias")])}


def _ffn(sd: Mapping, prefix: str) -> Dict:
    return {"Dense_0": _linear(sd, _j(prefix, "linear1")),
            "Dense_1": _linear(sd, _j(prefix, "linear2"))}


def convert_torch_encoder_layer(sd: Mapping, prefix: str, d_model: int,
                                num_heads: int) -> Dict:
    """torch nn.TransformerEncoderLayer -> EncoderBlock."""
    return {
        "MHA_0": _mha(sd, _j(prefix, "self_attn"), d_model, num_heads),
        "FFN_0": _ffn(sd, prefix),
        "LayerNorm_0": _norm(sd, _j(prefix, "norm1")),
        "LayerNorm_1": _norm(sd, _j(prefix, "norm2")),
    }


def convert_torch_decoder_layer(sd: Mapping, prefix: str, d_model: int,
                                num_heads: int) -> Dict:
    """torch nn.TransformerDecoderLayer -> DecoderBlock."""
    return {
        "self_attn": _mha(sd, _j(prefix, "self_attn"), d_model, num_heads),
        "cross_attn": _mha(sd, _j(prefix, "multihead_attn"), d_model,
                           num_heads),
        "FFN_0": _ffn(sd, prefix),
        "LayerNorm_0": _norm(sd, _j(prefix, "norm1")),
        "LayerNorm_1": _norm(sd, _j(prefix, "norm2")),
        "LayerNorm_2": _norm(sd, _j(prefix, "norm3")),
    }


def convert_reference_qformer(sd: Mapping, hidden: int, num_heads: int,
                              enc_layers: int, dec_layers: int,
                              prefix: str = "qformer") -> Dict:
    out = {"vision_proj": _linear(sd, _j(prefix, "vision_proj")),
           "query_tokens": _np(sd[_j(prefix, "query_tokens")])}
    for i in range(enc_layers):
        out[f"enc_{i}"] = convert_torch_encoder_layer(
            sd, _j(prefix, f"encoder.layers.{i}"), hidden, num_heads)
    for i in range(dec_layers):
        out[f"dec_{i}"] = convert_torch_decoder_layer(
            sd, _j(prefix, f"decoder.layers.{i}"), hidden, num_heads)
    return out


_PEFT_PREFIX_RE = re.compile(
    r"^llama_wrapper\.llama_model\.(?:base_model\.model\.)?")
_LORA_RE = re.compile(r"model\.layers\.(\d+)\.self_attn\.(\w+_proj)\."
                      r"lora_([AB])\.\w+\.weight")


def convert_reference_llama(sd: Mapping, num_layers: int,
                            consumed: Optional[set] = None) -> Dict:
    """The PEFT/HF Llama keys of a reference MLLM -> the Llama's Flax-path
    subtree: the wrapper prefix and PEFT's ``base_layer`` stripped, the
    plain HF names through ``llama_loader.convert_hf_state_dict``, the
    attention's LoRA factors grafted transposed.  An ``lm_head.weight``
    that differs from ``embed_tokens`` raises ``ValueError``: the Llama
    ties them."""
    from tsue_tpu_torch.models.llama_loader import convert_hf_state_dict
    plain, origin, lora = {}, {}, {}
    for k, v in sd.items():
        m = _PEFT_PREFIX_RE.match(k)
        if not m:
            continue
        k2 = k[m.end():]
        if ".lora_A." in k2 or ".lora_B." in k2:
            lora[k2] = (k, v)
            continue
        k2 = k2.replace(".base_layer.", ".")
        plain[k2] = v
        origin[k2] = k
    if "lm_head.weight" in plain:
        lm = plain["lm_head.weight"]
        emb = plain.get("model.embed_tokens.weight")
        if emb is None or not (lm is emb or np.array_equal(_np(lm),
                                                            _np(emb))):
            raise ValueError(
                f"{origin['lm_head.weight']} is untied from the input "
                "embedding, and the Llama ties them: its weights would be "
                "lost")
        if consumed is not None:
            consumed.add(origin["lm_head.weight"])
    view = plain if consumed is None else _KeyRecorder(plain, consumed,
                                                       origin)
    flat = {}
    for name, t in convert_hf_state_dict(view, num_layers).items():
        path = name.split(".")
        if path[-2:] == ["embed_tokens", "weight"]:
            path[-1] = "embedding"
        flat[tuple(path)] = _np(t)
    for k, (orig_k, v) in lora.items():
        m = _LORA_RE.fullmatch(k)
        if not m:
            continue
        i, proj, ab = m.groups()
        flat[("model", f"layer_{i}", "attn", proj,
              "lora_a" if ab == "A" else "lora_b")] = _np(v).T
        if consumed is not None:
            consumed.add(orig_k)
    return _unflatten(flat)


def convert_reference_mllm(sd: Mapping, qformer_cfg, llama_cfg,
                           consumed: Optional[set] = None) -> Dict:
    """A reference ``LlamaMultiModal`` state dict -> ``MultiModalLLM``."""
    view = _KeyRecorder(sd, consumed) if consumed is not None else sd
    out = {
        "qformer": convert_reference_qformer(
            view, qformer_cfg.hidden_size, qformer_cfg.num_heads,
            qformer_cfg.num_encoder_layers, qformer_cfg.num_decoder_layers),
        "vision_modality_embedding": _np(view["vision_modality_embedding"]),
        "text_modality_embedding": _np(view["text_modality_embedding"]),
        "llama": convert_reference_llama(sd, llama_cfg.num_layers, consumed),
    }
    if "q_proj.weight" in sd:
        out["q_proj"] = _linear(view, "q_proj")
    return out


# ---------------------------------------------------------------------------
# Stage-2 full model (MLLM + lane encoder + LTSF forecaster)
# ---------------------------------------------------------------------------

def _per_channel_linears(sd: Mapping, prefix: str, channels: int) -> Dict:
    """A ModuleList of per-channel nn.Linear(T_in, T_out) ->
    PerChannelLinear {kernel (C, T_in, T_out), bias (C, T_out)} (ref
    scripts/train.py:703-709, 772-778)."""
    ws = [_np(sd[f"{prefix}.{c}.weight"]).T for c in range(channels)]
    bs = [_np(sd[f"{prefix}.{c}.bias"]) for c in range(channels)]
    return {"kernel": np.stack(ws), "bias": np.stack(bs)}


def convert_reference_lane_encoder(sd: Mapping, lane_cfg,
                                   prefix: str = "lane_polygon_encoder"
                                   ) -> Dict:
    """Ref LanePolygonEncoder (scripts/train.py:352-383)."""
    out = {"input_proj": _linear(sd, _j(prefix, "input_proj")),
           "pos_embedding": _np(sd[_j(prefix, "pos_embedding")])}
    for i in range(lane_cfg.num_layers):
        out[f"block_{i}"] = convert_torch_encoder_layer(
            sd, _j(prefix, f"encoder.layers.{i}"), lane_cfg.d_model,
            lane_cfg.nhead)
    return out


def convert_reference_ltsf(sd: Mapping, ltsf_cfg, cross_dim: int,
                           prefix: str = "ltsf",
                           use_cross_attn: bool = True) -> Dict:
    """Ref TransformerLTSF (scripts/train.py:659-842): the Conv1d(k=1)
    ``token_proj`` -> Dense, the per-channel ModuleLists -> one kernel,
    ``attn_block`` (norm1/mha/ffn.0/ffn.3), the decoder (decoder_linears,
    lane_fc, post_mlp.0/.3, dec_proj/dec_unproj, cross_attn,
    fusion_layer.0 (LN)/.1/.3, out_proj)."""
    C = ltsf_cfg.d_model
    conv_w = _np(sd[_j(prefix, "token_proj.weight")])  # (C_out, C_in, 1)
    out = {
        "token_proj": {"kernel": conv_w[:, :, 0].T,
                       "bias": _np(sd[_j(prefix, "token_proj.bias")])},
        "nlinear_encoder": {"linears": _per_channel_linears(
            sd, _j(prefix, "nlinear_encoder.encoder_linears"), C)},
        "pos_encoding": _np(sd[_j(prefix, "pos_encoding")]),
        "attn_block": {
            "norm1": _norm(sd, _j(prefix, "attn_block.norm1")),
            "norm2": _norm(sd, _j(prefix, "attn_block.norm2")),
            "mha": _mha(sd, _j(prefix, "attn_block.mha"), C,
                        ltsf_cfg.nhead),
            "ffn1": _linear(sd, _j(prefix, "attn_block.ffn.0")),
            "ffn2": _linear(sd, _j(prefix, "attn_block.ffn.3")),
        },
    }
    dec = {
        "linears": _per_channel_linears(
            sd, _j(prefix, "decoder.decoder_linears"), C),
        "lane_fc": _linear(sd, _j(prefix, "decoder.lane_fc")),
        "post_mlp1": _linear(sd, _j(prefix, "decoder.post_mlp.0")),
        "post_mlp2": _linear(sd, _j(prefix, "decoder.post_mlp.3")),
        "fusion_ln": _norm(sd, _j(prefix, "decoder.fusion_layer.0")),
        "fusion_fc1": _linear(sd, _j(prefix, "decoder.fusion_layer.1")),
        "fusion_fc2": _linear(sd, _j(prefix, "decoder.fusion_layer.3")),
        "out_proj": _linear(sd, _j(prefix, "decoder.out_proj")),
    }
    if use_cross_attn:
        dec["dec_proj"] = _linear(sd, _j(prefix, "decoder.dec_proj"))
        dec["dec_unproj"] = _linear(sd, _j(prefix, "decoder.dec_unproj"))
        dec["cross_attn"] = _mha(sd, _j(prefix, "decoder.cross_attn"),
                                 cross_dim, ltsf_cfg.cross_nhead)
    out["decoder"] = dec
    return out


def convert_reference_stage2(sd: Mapping, model_cfg,
                             consumed: Optional[set] = None) -> Dict:
    """A reference ``MultiModalTrajectoryModel`` state dict (the best-val
    artifact, ref scripts/train.py:1219-1224) -> ``TrajectoryModel``."""
    view = _KeyRecorder(sd, consumed) if consumed is not None else sd
    out = {"lane_encoder": convert_reference_lane_encoder(view,
                                                          model_cfg.lane)}
    if model_cfg.use_llm:
        mllm_sd = {k[len("mllm."):]: v for k, v in sd.items()
                   if k.startswith("mllm.")}
        sub: Optional[set] = set() if consumed is not None else None
        out["mllm"] = convert_reference_mllm(
            mllm_sd, model_cfg.qformer, model_cfg.llama, sub)
        if consumed is not None:
            consumed.update("mllm." + k for k in sub)
    out["ltsf"] = convert_reference_ltsf(
        view, model_cfg.ltsf, model_cfg.llama.hidden_size,
        use_cross_attn=model_cfg.use_llm)
    return out


# HF Llama's rotary table: a buffer of older ``transformers``, no weight
_BUFFER_RE = re.compile(r"(^|\.)rotary_emb\.inv_freq$")


def check_consumed(sd: Mapping, consumed: set) -> None:
    """Raise ``KeyError`` naming every key of ``sd`` that no conversion
    read (the rotary tables of older ``transformers`` aside)."""
    left = sorted(k for k in set(sd) - consumed if not _BUFFER_RE.search(k))
    if left:
        raise KeyError(f"{len(left)} checkpoint keys map to no parameter of "
                       f"the port: {left[:8]}")


def strip_lora_tree(tree: Mapping) -> Dict:
    """``tree`` without its LoRA factors, through
    ``train.checkpoint.strip_lora`` (ref
    ablation_study_without_lora.py:1070-1084)."""
    from tsue_tpu_torch.train.checkpoint import strip_lora
    kept = strip_lora({".".join(k): v for k, v in _flatten(tree).items()})
    return _unflatten({tuple(k.split(".")): v for k, v in kept.items()})
