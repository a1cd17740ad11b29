"""HF Llama checkpoints into the port's LlamaForCausalLM.

Counterpart of ``tsue_tpu/models/llama_loader.py`` (``convert_hf_state_dict``,
``load_hf_llama``, ``load_hf_llama_from_dir``).  An HF ``state_dict`` maps
onto the port's Flax-named modules:

  model.embed_tokens.weight        -> model.embed_tokens.weight
  model.layers.{i}.self_attn.{q,k,v,o}_proj.weight, (out, in) transposed
                                   -> model.layer_{i}.attn.*.kernel
  model.layers.{i}.mlp.{gate,up,down}_proj.weight, transposed
                                   -> model.layer_{i}.mlp.*.kernel
  model.layers.{i}.input_layernorm.weight
                                   -> model.layer_{i}.input_norm.scale
  model.layers.{i}.post_attention_layernorm.weight
                                   -> model.layer_{i}.post_attn_norm.scale
  model.norm.weight                -> model.final_norm.scale
  lm_head.weight (untied only)     -> lm_head.weight

The head layout and the half-split rotary embedding are HF's Llama
convention (``tests/test_torch_llama_loader.py`` holds the logits to a
``transformers`` model's).  LoRA adapters keep their init.

A local checkout is read without ``safetensors`` or ``transformers``:
``*.safetensors`` by ``read_safetensors`` (a little-endian u64 header
length, a JSON header, then the raw little-endian tensors), otherwise
``pytorch_model*.bin`` by ``torch.load(..., weights_only=True)``.
"""
from __future__ import annotations

import json
import os
import re
import sys
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def _tensor(v: Any) -> torch.Tensor:
    """A checkpoint value as a tensor: a torch tensor stays on its device,
    a numpy array becomes a CPU tensor over its memory."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.asarray(v))


def convert_hf_state_dict(state_dict: Mapping[str, Any], num_layers: int,
                          tie_word_embeddings: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """HF keys and layouts -> the port's parameter names (relative to a
    LlamaForCausalLM) and layouts, values in the checkpoint's dtype.  A
    missing key raises ``KeyError``."""
    sd = state_dict
    out = {"model.embed_tokens.weight":
           _tensor(sd["model.embed_tokens.weight"]),
           "model.final_norm.scale": _tensor(sd["model.norm.weight"])}
    if not tie_word_embeddings and "lm_head.weight" in sd:
        out["lm_head.weight"] = _tensor(sd["lm_head.weight"])
    for i in range(num_layers):
        hf, pt = f"model.layers.{i}", f"model.layer_{i}"
        for name in _ATTN:
            out[f"{pt}.attn.{name}.kernel"] = _tensor(
                sd[f"{hf}.self_attn.{name}.weight"]).t()
        for name in _MLP:
            out[f"{pt}.mlp.{name}.kernel"] = _tensor(
                sd[f"{hf}.mlp.{name}.weight"]).t()
        out[f"{pt}.input_norm.scale"] = _tensor(
            sd[f"{hf}.input_layernorm.weight"])
        out[f"{pt}.post_attn_norm.scale"] = _tensor(
            sd[f"{hf}.post_attention_layernorm.weight"])
    return out


@torch.no_grad()
def load_hf_llama(model: nn.Module, state_dict: Mapping[str, Any],
                  num_layers: Optional[int] = None,
                  tie_word_embeddings: Optional[bool] = None) -> nn.Module:
    """Replace the base weights of ``model`` (a LlamaForCausalLM of the
    port) in place with the converted HF weights, each cast to its
    parameter's dtype and copied on its device.  Shapes are checked leaf by
    leaf; parameters absent from the checkpoint (LoRA adapters) keep their
    values.  ``num_layers`` and ``tie_word_embeddings`` default to the
    model's config.  Returns ``model``."""
    cfg = model.cfg
    converted = convert_hf_state_dict(
        state_dict, cfg.num_layers if num_layers is None else num_layers,
        cfg.tie_word_embeddings if tie_word_embeddings is None
        else tie_word_embeddings)
    params = dict(model.named_parameters())
    for name, v in converted.items():
        if name not in params:
            raise KeyError(f"converted key {name} not in the model")
        p = params[name]
        if tuple(p.shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {name}: model "
                             f"{tuple(p.shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
        p.copy_(v.to(p.dtype))
    return model


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of one ``.safetensors`` file, on the CPU: 8 bytes of
    little-endian header length, the JSON header ({name: {dtype, shape,
    data_offsets}}, and ``__metadata__``), then the data, each tensor's
    bytes little-endian at its offsets past the header."""
    if sys.byteorder != "little":
        raise RuntimeError("read_safetensors reads on little-endian hosts")
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    n = int.from_bytes(buf[:8], "little")
    header = json.loads(buf[8:8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             "which the reader does not take")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize:
            raise ValueError(f"{path}: {name} spans {end - begin} bytes, "
                             f"its shape {shape} needs {count * itemsize}")
        t = (torch.frombuffer(buf, dtype=dtype, count=count,
                              offset=base + begin) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def read_hf_dir(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a local HF checkout: every ``*.safetensors`` file,
    or else every ``pytorch_model*.bin`` (``weights_only``), in name
    order."""
    files = sorted(os.listdir(path))
    sd: Dict[str, torch.Tensor] = {}
    st = [f for f in files if f.endswith(".safetensors")]
    if st:
        for f in st:
            sd.update(read_safetensors(os.path.join(path, f)))
        return sd
    bins = [f for f in files if re.match(r"pytorch_model.*\.bin$", f)]
    if not bins:
        raise FileNotFoundError(f"{path}: no *.safetensors or "
                                "pytorch_model*.bin")
    for f in bins:
        sd.update(torch.load(os.path.join(path, f), map_location="cpu",
                             weights_only=True))
    return sd


def load_hf_llama_from_dir(model: nn.Module, path: str,
                           num_layers: Optional[int] = None,
                           tie_word_embeddings: Optional[bool] = None
                           ) -> nn.Module:
    """``load_hf_llama`` from a local HF checkout (``read_hf_dir``)."""
    return load_hf_llama(model, read_hf_dir(path), num_layers,
                         tie_word_embeddings)
