"""HF Llama checkpoints into the port (``models/llama_loader.py``), on the
CPU.

A tiny random ``transformers`` ``LlamaForCausalLM`` (as
``tests/test_llama_loader.py`` builds it) loaded into the port's
LlamaForCausalLM gives its logits within 2e-4 (fp32 on both sides, attention
summed in other orders), with and without padding; the port's converted
parameters equal the JAX package's ``convert_hf_state_dict`` tree carried
over by ``convert.load_flax_params``; the port's own safetensors reader
reads what ``safetensors.torch.save_file`` writes, fp32 and bf16, bit for
bit; a ``pytorch_model.bin`` checkout loads through ``weights_only``; shape
mismatches and missing keys raise.  ``safetensors`` and ``transformers`` are
imported here only: the port reads checkpoints without them.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tsue_tpu.models.llama_loader import \
    convert_hf_state_dict as jax_convert
from tsue_tpu_torch.config import LlamaConfig
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.models import llama_loader as LL
from tsue_tpu_torch.models.llama import LlamaForCausalLM
from tsue_tpu_torch.models.tsue import init_params

# transformers would import TensorFlow, seconds spent on nothing this file
# uses; it reads USE_TF once, at its own import
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

VOCAB, HID, INT, LAYERS, HEADS, KV, DH = 128, 32, 64, 2, 4, 2, 8
FIELDS = dict(vocab_size=VOCAB, hidden_size=HID, intermediate_size=INT,
              num_layers=LAYERS, num_heads=HEADS, num_kv_heads=KV,
              head_dim=DH, rope_theta=10000.0, rope_scaling_factor=1.0,
              use_lora=True, lora_dropout=0.0)


@pytest.fixture(scope="module")
def hf_model():
    cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=HID, intermediate_size=INT,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=KV, head_dim=DH, tie_word_embeddings=True,
        rope_theta=10000.0, rms_norm_eps=1e-5, attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _port(**over):
    """A port LlamaForCausalLM with random weights (``init_params``)."""
    model = LlamaForCausalLM(LlamaConfig(**{**FIELDS, **over}))
    return init_params(model, torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def loaded(hf_model):
    model = _port()
    lora = {n: p.clone() for n, p in model.named_parameters()
            if "lora" in n}
    LL.load_hf_llama(model, hf_model.state_dict())
    return model, lora


def _logits(model, ids, mask):
    with torch.no_grad():
        emb = model.embed(torch.as_tensor(ids))
        return model(emb, torch.as_tensor(mask),
                     compute_logits=True)["logits"].numpy()


@pytest.mark.parametrize("padded", [False, True])
def test_logit_parity_with_transformers(hf_model, loaded, padded):
    model, _ = loaded
    rng = np.random.default_rng(1 + padded)
    ids = rng.integers(0, VOCAB, (2, 12))
    mask = np.ones((2, 12), np.int64)
    if padded:
        mask[:, 9:] = 0
    with torch.no_grad():
        ref = hf_model(torch.tensor(ids),
                       attention_mask=torch.tensor(mask)).logits.numpy()
    out = _logits(model, ids, mask)
    valid = 9 if padded else 12     # HF computes the pads too
    np.testing.assert_allclose(out[:, :valid], ref[:, :valid], atol=2e-4,
                               rtol=2e-4)


def test_lora_adapters_keep_their_init(loaded):
    model, lora = loaded
    for n, p in model.named_parameters():
        if "lora" in n:
            assert torch.equal(p, lora[n]), n


def test_converted_tree_equals_the_jax_loader(hf_model, loaded):
    """The JAX package's ``convert_hf_state_dict`` tree, carried into a
    port model without adapters by ``load_flax_params`` (strict: every
    leaf and every parameter once): every base weight equal to the port
    loader's."""
    model, _ = loaded
    tree = jax_convert(hf_model.state_dict(), LAYERS)
    theirs = dict(load_flax_params(_port(use_lora=False),
                                   tree).named_parameters())
    converted = LL.convert_hf_state_dict(hf_model.state_dict(), LAYERS)
    assert set(converted) == set(theirs)
    for n, p in model.named_parameters():
        if "lora" not in n:
            assert torch.equal(p, theirs[n]), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_safetensors_reader(tmp_path, dtype):
    """The reader gives what ``safetensors.torch.save_file`` wrote, bit
    for bit and dtype for dtype, with metadata, an int tensor and a 0-d
    one; a checkout of it loads into a model of that dtype."""
    rng = np.random.default_rng(3)
    tensors = {"a": torch.from_numpy(rng.standard_normal(
        (3, 5)).astype(np.float32)).to(dtype),
        "b.c": torch.arange(7, dtype=torch.int64),
        "d": torch.tensor(2.5, dtype=dtype)}
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = LL.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape
        assert torch.equal(got[k], t), k


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_from_dir(tmp_path, hf_model, loaded, fmt):
    """A local checkout written by the test, two safetensors shards in
    bf16 or one ``pytorch_model.bin`` in fp32: the loaded model equals the
    one loaded from the state dict (the bf16 shards rounded)."""
    model, _ = loaded
    sd = {k: v.detach().clone() for k, v in hf_model.state_dict().items()}
    if fmt == "safetensors":
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
        keys = sorted(sd)
        half = len(keys) // 2
        for i, part in enumerate((keys[:half], keys[half:])):
            safetensors_torch.save_file(
                {k: sd[k].contiguous() for k in part},
                str(tmp_path / f"model-0000{i + 1}-of-00002.safetensors"))
    else:
        torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    dst = LL.load_hf_llama_from_dir(_port(), str(tmp_path))
    ref = dict(model.named_parameters())
    for n, p in dst.named_parameters():
        if "lora" in n:
            continue
        want = ref[n] if fmt == "bin" else ref[n].to(torch.bfloat16).float()
        assert torch.equal(p, want), n
    bf = LL.load_hf_llama_from_dir(
        torch.nn.Module.to(_port(), torch.bfloat16), str(tmp_path))
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}


def test_mismatches_and_missing_keys_raise(tmp_path, hf_model):
    sd = hf_model.state_dict()
    with pytest.raises(ValueError, match="shape mismatch"):
        LL.load_hf_llama(_port(head_dim=4), sd)
    with pytest.raises(KeyError, match="o_proj"):
        LL.load_hf_llama(_port(), {k: v for k, v in sd.items()
                                   if "layers.1.self_attn.o_proj" not in k})
    with pytest.raises(KeyError):
        LL.load_hf_llama(_port(num_layers=3), sd)
    with pytest.raises(FileNotFoundError):
        LL.load_hf_llama_from_dir(_port(), str(tmp_path))
