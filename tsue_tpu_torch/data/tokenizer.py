"""Tokenizers.

The reference uses HF ``AutoTokenizer.from_pretrained("meta-llama/Llama-3.2-1B")``
(ref scripts/train.py:1056).  In an air-gapped TPU environment pretrained
tokenizer files may be unavailable, so the framework ships a deterministic,
dependency-free **byte-level tokenizer** as the default, and transparently uses
an HF tokenizer when a local path/name resolves.

Both expose the same minimal surface the data layer needs:
``encode(text) -> List[int]``, ``decode(ids) -> str``, ``pad_id``, ``eos_id``,
``vocab_size``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence


class ByteTokenizer:
    """UTF-8 byte tokenizer with special tokens.

    id 0 = pad, 1 = bos, 2 = eos, 3..258 = bytes 0..255.
    vocab_size is padded to a multiple of 128 (=384) so the embedding table
    tiles cleanly onto the TPU lane dimension.
    """

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _OFFSET = 3

    def __init__(self, vocab_pad_multiple: int = 128):
        raw = self._OFFSET + 256
        self.vocab_size = ((raw + vocab_pad_multiple - 1)
                           // vocab_pad_multiple) * vocab_pad_multiple

    def encode(self, text: str, add_special_tokens: bool = False,
               max_length: Optional[int] = None) -> List[int]:
        ids = [b + self._OFFSET for b in text.encode("utf-8")]
        if add_special_tokens:
            ids = [self.bos_id] + ids
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        # ids in the padded vocab tail (>= 259) have no byte; skip them
        bs = bytes(i - self._OFFSET for i in ids
                   if self._OFFSET <= i < self._OFFSET + 256)
        return bs.decode("utf-8", errors="replace")

    def __call__(self, text, truncation=True, max_length=None,
                 add_special_tokens=False):
        ids = self.encode(text, add_special_tokens=add_special_tokens,
                          max_length=max_length if truncation else None)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}


class HFTokenizerAdapter:
    """Wraps a HuggingFace tokenizer behind the ByteTokenizer surface."""

    def __init__(self, hf_tokenizer):
        self.hf = hf_tokenizer
        if self.hf.pad_token is None:
            self.hf.pad_token = self.hf.eos_token
        self.pad_id = self.hf.pad_token_id or 0
        self.eos_id = self.hf.eos_token_id
        self.bos_id = self.hf.bos_token_id
        self.vocab_size = len(self.hf)

    def encode(self, text, add_special_tokens=False, max_length=None):
        return self.hf.encode(text, add_special_tokens=add_special_tokens,
                              truncation=max_length is not None,
                              max_length=max_length)

    def decode(self, ids, skip_special_tokens=True):
        return self.hf.decode(ids, skip_special_tokens=skip_special_tokens)

    def __call__(self, text, truncation=True, max_length=None,
                 add_special_tokens=False):
        enc = self.hf(text, truncation=truncation, max_length=max_length,
                      add_special_tokens=add_special_tokens)
        return {"input_ids": enc["input_ids"],
                "attention_mask": enc["attention_mask"]}


def get_tokenizer(name_or_path: Optional[str] = None):
    """Resolve a tokenizer: HF if loadable from local files, else bytes."""
    if name_or_path:
        try:
            from transformers import AutoTokenizer
            tok = AutoTokenizer.from_pretrained(name_or_path,
                                                local_files_only=True)
            return HFTokenizerAdapter(tok)
        except Exception:
            pass
    return ByteTokenizer()
