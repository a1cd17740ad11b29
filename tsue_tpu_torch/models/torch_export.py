"""Export the port's models to the reference's own PyTorch state dicts.

Counterpart of ``tsue_tpu/models/torch_export.py`` and the inverse of
``models.torch_import``: a ``MultiModalLLM`` becomes a state dict that the
reference's ``LlamaMultiModal`` loads with ``strict=True`` (the
``mllm_lora_ddp_finetuned.pt`` artifact, ref scripts/train.py:1137-1138),
and a ``TrajectoryModel`` the whole ``MultiModalTrajectoryModel`` state
dict the reference saves on val improvement (ref scripts/train.py:
1219-1224).  The exporters read the Flax-path tree that
``convert.flax_params(model)`` gives, so the key map is this module's
alone.

Structure is inferred from the tree: layer counts from the key names,
head counts from the ``(d, h, dh)`` attention kernels, PEFT naming
(``base_model.model.`` prefix, ``base_layer``, ``lora_A/B.default``)
exactly where LoRA leaves exist; a LoRA-free tree gives plain HF names
(the no-LoRA ablation's layout, ref
scripts/ablation_study_without_lora.py:1070-1084).  Every value is an fp32
numpy array; ``to_torch_state_dict`` makes the tensors to ``torch.save``.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _np(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _set_linear(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])


def _set_norm(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _set_mha(out: Dict, prefix: str, p: Mapping) -> None:
    """MHA (q/k/v kernels (d, h, dh), o kernel (h, dh, d)) -> torch
    nn.MultiheadAttention's packed in_proj and out_proj."""
    d = _np(p["q"]["kernel"]).shape[0]
    ws, bs = [], []
    for name in ("q", "k", "v"):
        ws.append(_np(p[name]["kernel"]).reshape(d, d).T)   # (d_out, d_in)
        bs.append(_np(p[name]["bias"]).reshape(d))
    out[f"{prefix}.in_proj_weight"] = np.concatenate(ws, axis=0)
    out[f"{prefix}.in_proj_bias"] = np.concatenate(bs, axis=0)
    out[f"{prefix}.out_proj.weight"] = _np(p["o"]["kernel"]).reshape(d, d).T
    out[f"{prefix}.out_proj.bias"] = _np(p["o"]["bias"])


def _set_encoder_layer(out: Dict, prefix: str, p: Mapping) -> None:
    """EncoderBlock -> torch nn.TransformerEncoderLayer."""
    _set_mha(out, f"{prefix}.self_attn", p["MHA_0"])
    _set_linear(out, f"{prefix}.linear1", p["FFN_0"]["Dense_0"])
    _set_linear(out, f"{prefix}.linear2", p["FFN_0"]["Dense_1"])
    _set_norm(out, f"{prefix}.norm1", p["LayerNorm_0"])
    _set_norm(out, f"{prefix}.norm2", p["LayerNorm_1"])


def _set_decoder_layer(out: Dict, prefix: str, p: Mapping) -> None:
    """DecoderBlock -> torch nn.TransformerDecoderLayer."""
    _set_mha(out, f"{prefix}.self_attn", p["self_attn"])
    _set_mha(out, f"{prefix}.multihead_attn", p["cross_attn"])
    _set_linear(out, f"{prefix}.linear1", p["FFN_0"]["Dense_0"])
    _set_linear(out, f"{prefix}.linear2", p["FFN_0"]["Dense_1"])
    _set_norm(out, f"{prefix}.norm1", p["LayerNorm_0"])
    _set_norm(out, f"{prefix}.norm2", p["LayerNorm_1"])
    _set_norm(out, f"{prefix}.norm3", p["LayerNorm_2"])


def _layer_indices(p: Mapping, pattern: str) -> list:
    """Sorted layer indices in a subtree, e.g. enc_0, enc_1 -> [0, 1]."""
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(pattern, k) for k in p) if m)


def export_reference_qformer(p: Mapping, prefix: str = "qformer") -> Dict:
    out: Dict[str, np.ndarray] = {}
    _set_linear(out, f"{prefix}.vision_proj", p["vision_proj"])
    out[f"{prefix}.query_tokens"] = _np(p["query_tokens"])
    for i in _layer_indices(p, r"enc_(\d+)"):
        _set_encoder_layer(out, f"{prefix}.encoder.layers.{i}", p[f"enc_{i}"])
    for i in _layer_indices(p, r"dec_(\d+)"):
        _set_decoder_layer(out, f"{prefix}.decoder.layers.{i}", p[f"dec_{i}"])
    return out


def _set_projection(out: Dict, prefix: str, p: Mapping) -> None:
    """An HF/PEFT projection: ``base_layer`` and ``lora_A/B.default``
    where the tree has LoRA factors, the plain weight elsewhere."""
    if "lora_a" in p:
        out[f"{prefix}.base_layer.weight"] = _np(p["kernel"]).T
        out[f"{prefix}.lora_A.default.weight"] = _np(p["lora_a"]).T
        out[f"{prefix}.lora_B.default.weight"] = _np(p["lora_b"]).T
    else:
        out[f"{prefix}.weight"] = _np(p["kernel"]).T


def export_reference_llama(p: Mapping,
                           prefix: str = "llama_wrapper.llama_model"
                           ) -> Dict:
    """The Llama's subtree -> HF/PEFT state-dict keys (PEFT's names where
    the tree carries LoRA, as ``peft.get_peft_model`` gives them for the
    reference's LoraConfig, ref scripts/train.py:433-440)."""
    model = p["model"]
    layers = _layer_indices(model, r"layer_(\d+)")
    has_lora = any("lora_a" in sub for i in layers
                   for sub in model[f"layer_{i}"]["attn"].values())
    base = f"{prefix}.base_model.model" if has_lora else prefix
    out: Dict[str, np.ndarray] = {}
    emb = _np(model["embed_tokens"]["embedding"])
    out[f"{base}.model.embed_tokens.weight"] = emb
    out[f"{base}.model.norm.weight"] = _np(model["final_norm"]["scale"])
    # torch state dicts carry tied weights under both names
    out[f"{base}.lm_head.weight"] = (_np(p["lm_head"]["kernel"]).T
                                     if "lm_head" in p else emb)
    for i in layers:
        lp = model[f"layer_{i}"]
        hf = f"{base}.model.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _set_projection(out, f"{hf}.self_attn.{proj}", lp["attn"][proj])
        for proj in ("gate_proj", "up_proj", "down_proj"):
            _set_projection(out, f"{hf}.mlp.{proj}", lp["mlp"][proj])
        out[f"{hf}.input_layernorm.weight"] = _np(lp["input_norm"]["scale"])
        out[f"{hf}.post_attention_layernorm.weight"] = \
            _np(lp["post_attn_norm"]["scale"])
    return out


def export_reference_mllm(p: Mapping) -> Dict:
    """``MultiModalLLM`` -> the reference ``LlamaMultiModal`` state dict
    (the stage-1 artifact, ref scripts/train.py:459-530)."""
    out = export_reference_qformer(p["qformer"])
    out["vision_modality_embedding"] = _np(p["vision_modality_embedding"])
    out["text_modality_embedding"] = _np(p["text_modality_embedding"])
    if "q_proj" in p:
        _set_linear(out, "q_proj", p["q_proj"])
    out.update(export_reference_llama(p["llama"]))
    return out


# ---------------------------------------------------------------------------
# Stage-2 full model (lane encoder + MLLM + LTSF), ref train.py:847-964
# ---------------------------------------------------------------------------

def _set_per_channel_linears(out: Dict, prefix: str, p: Mapping) -> None:
    """PerChannelLinear {kernel (C, T_in, T_out), bias (C, T_out)} -> a
    ModuleList of per-channel nn.Linear (ref scripts/train.py:703-709)."""
    k, b = _np(p["kernel"]), _np(p["bias"])
    for c in range(k.shape[0]):
        out[f"{prefix}.{c}.weight"] = k[c].T
        out[f"{prefix}.{c}.bias"] = b[c]


def export_reference_lane_encoder(p: Mapping,
                                  prefix: str = "lane_polygon_encoder"
                                  ) -> Dict:
    out: Dict[str, np.ndarray] = {}
    _set_linear(out, f"{prefix}.input_proj", p["input_proj"])
    out[f"{prefix}.pos_embedding"] = _np(p["pos_embedding"])
    for i in _layer_indices(p, r"block_(\d+)"):
        _set_encoder_layer(out, f"{prefix}.encoder.layers.{i}",
                           p[f"block_{i}"])
    return out


def export_reference_ltsf(p: Mapping, prefix: str = "ltsf") -> Dict:
    out: Dict[str, np.ndarray] = {}
    # Dense kernel (2, C) -> Conv1d(k=1) weight (C, 2, 1)
    out[f"{prefix}.token_proj.weight"] = \
        _np(p["token_proj"]["kernel"]).T[:, :, None]
    out[f"{prefix}.token_proj.bias"] = _np(p["token_proj"]["bias"])
    _set_per_channel_linears(out, f"{prefix}.nlinear_encoder.encoder_linears",
                             p["nlinear_encoder"]["linears"])
    out[f"{prefix}.pos_encoding"] = _np(p["pos_encoding"])
    ab = p["attn_block"]
    _set_norm(out, f"{prefix}.attn_block.norm1", ab["norm1"])
    _set_norm(out, f"{prefix}.attn_block.norm2", ab["norm2"])
    _set_mha(out, f"{prefix}.attn_block.mha", ab["mha"])
    _set_linear(out, f"{prefix}.attn_block.ffn.0", ab["ffn1"])
    _set_linear(out, f"{prefix}.attn_block.ffn.3", ab["ffn2"])
    dec = p["decoder"]
    _set_per_channel_linears(out, f"{prefix}.decoder.decoder_linears",
                             dec["linears"])
    _set_linear(out, f"{prefix}.decoder.lane_fc", dec["lane_fc"])
    _set_linear(out, f"{prefix}.decoder.post_mlp.0", dec["post_mlp1"])
    _set_linear(out, f"{prefix}.decoder.post_mlp.3", dec["post_mlp2"])
    _set_norm(out, f"{prefix}.decoder.fusion_layer.0", dec["fusion_ln"])
    _set_linear(out, f"{prefix}.decoder.fusion_layer.1", dec["fusion_fc1"])
    _set_linear(out, f"{prefix}.decoder.fusion_layer.3", dec["fusion_fc2"])
    _set_linear(out, f"{prefix}.decoder.out_proj", dec["out_proj"])
    if "cross_attn" in dec:
        _set_linear(out, f"{prefix}.decoder.dec_proj", dec["dec_proj"])
        _set_linear(out, f"{prefix}.decoder.dec_unproj", dec["dec_unproj"])
        _set_mha(out, f"{prefix}.decoder.cross_attn", dec["cross_attn"])
    return out


def export_reference_stage2(p: Mapping) -> Dict:
    """``TrajectoryModel`` -> the reference ``MultiModalTrajectoryModel``
    state dict (the best-val artifact, ref scripts/train.py:1219-1224)."""
    out = export_reference_lane_encoder(p["lane_encoder"])
    if "mllm" in p:
        out.update({f"mllm.{k}": v
                    for k, v in export_reference_mllm(p["mllm"]).items()})
    out.update(export_reference_ltsf(p["ltsf"]))
    return out


def to_torch_state_dict(exported: Mapping[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """The numpy export as contiguous CPU tensors (for ``torch.save``).
    One array under two names (the tied ``lm_head``) becomes one tensor
    under both, so ``torch.save`` writes it once, as it writes a tied
    model's state dict."""
    tensors: Dict[int, torch.Tensor] = {}
    out = {}
    for k, v in exported.items():
        if id(v) not in tensors:
            tensors[id(v)] = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = tensors[id(v)]
    return out
