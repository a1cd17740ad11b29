"""Sharded serving: TP(+DP) generation over a ``(data, model)`` mesh.

Counterpart of ``tsue_tpu/parallel/serve_tp.py`` (``make_sharded_generate_
fn``).  The weights are placed once: this rank's model-axis shards of the
one-process state (``parallel.sharding.shard_state``) in the local-shard
MLLM of ``models/llama.py``, whose projections all-reduce their partial
sums and whose embedding gathers its feature slices; with ``fsdp`` the
large parameters are also ZeRO-sharded over data (FSDP2).  Requests are
sharded over data: each data rank decodes its contiguous rows, and the
ids are gathered whole on every rank.

- ``quantize_decode``: the int8 tables are built from the one-process
  weights before placement (``tsue_tpu/parallel/serve_tp.py:110-113``), so
  their scales are the one-device scales cut into shards;
- ``fused_head``: the kernel takes the whole head table, as the JAX
  kernel's partition rule takes it replicated
  (``tsue_tpu/ops/lmhead_topk.py:371-383``), so under TP each rank keeps a
  whole copy beside its shard (``head_table``): 1.05 GB for the tied fp32
  table of Llama-3.2-1B, 263 MB for the int8 one;
- ``quantize_kv`` and ``speculative`` apply per rank as on one device.

The kernels keep their one-device routes: no implementation switch is
needed under a mesh.  A data rank's sampled draws come from its own stream
(the caller's generator folded with the data rank), the same on its model
ranks.  Correctness: TP splits the contractions, so the logits agree with
one device to rounding and greedy ids can flip only at near-ties; pure DP
runs each row on one rank, the one-device decode at a smaller batch (the
kernels' launch plans depend on the batch, so on the card the bits may
differ; on the CPU the plain path gives the same rows).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from tsue_tpu_torch.ops.sampling import SamplingConfig
from tsue_tpu_torch.parallel import mesh as M
from tsue_tpu_torch.parallel.sharding import (FSDP_MIN_SIZE, apply_fsdp,
                                              shard_state)
from tsue_tpu_torch.utils.random import step_generator


def place(build, state: Mapping[str, torch.Tensor], mesh: M.Mesh,
          fsdp: bool = False, fsdp_min_size: Optional[int] = None,
          quantize_decode: bool = False, fused_head: bool = False):
    """Place the one-process ``state`` on ``mesh`` once: ``build(mesh)``
    builds the rank's local-shard module (a ``MultiModalLLM`` or a model
    holding one) on ``mesh.device``, which takes its shards of ``state``
    and is returned in eval mode.

    - ``quantize_decode``: the int8 tables are built from ``state`` in the
      one-process module (``build(None)``, on the meta device) before the
      cut, so their scales are the one-device scales
      (``tsue_tpu/parallel/serve_tp.py:110-113``); the rank keeps its
      shards of them, attached;
    - ``fsdp``: the parameters of at least ``fsdp_min_size`` elements
      (default ``FSDP_MIN_SIZE``) are FSDP-sharded over data;
    - ``fused_head``: where the rank holds less than the whole head (TP,
      FSDP), the head's whole table is kept beside its shard: the (V, D)
      embedding, or the int8 pair."""
    from tsue_tpu_torch.models.llama import LlamaForCausalLM
    from tsue_tpu_torch.ops.quant import attach_quant, quantize_llama_params
    with torch.device(mesh.device):
        local = build(mesh)
    load_shards(local, state, mesh)
    tables = None
    if quantize_decode:
        with torch.device("meta"):
            full = build(None)
        full.load_state_dict(state, strict=True, assign=True)
        with torch.no_grad():
            tables = quantize_llama_params(full)
    head = None
    if fused_head and (mesh.model > 1 or fsdp):
        llama = next(n for n, m in local.named_modules()
                     if isinstance(m, LlamaForCausalLM))
        pre = f"{llama}." if llama else ""
        head = ((tables[f"{pre}lm_head_w8"].to(mesh.device),
                 tables[f"{pre}lm_head_scale"].to(mesh.device))
                if tables is not None else
                state[f"{pre}model.embed_tokens.weight"].to(mesh.device))
        local.get_submodule(llama).head_table = head
    if fsdp:
        apply_fsdp(local, mesh, FSDP_MIN_SIZE if fsdp_min_size is None
                   else fsdp_min_size)
    if tables is not None:
        attach_quant(local, {k: v.to(mesh.device) for k, v in
                             shard_state(tables, mesh).items()})
    return local.eval()


class ShardedProgram:
    """A decode program over this rank's rows of the batch: (vision,
    prompt_ids, prompt_mask, generator) on the global batch -> the global
    (B, max_new_tokens) ids on every rank.  ``steps``, ``forwards``,
    ``cfg`` and ``timing_ms`` are the local program's."""

    def __init__(self, program, mesh: M.Mesh):
        self.program = program
        self.mesh = mesh

    def __getattr__(self, name):
        return getattr(self.program, name)

    def __call__(self, vision, prompt_ids, prompt_mask, generator):
        mesh = self.mesh
        B = prompt_ids.shape[0]
        if B % mesh.data:
            raise ValueError(f"batch {B} must divide the data axis "
                             f"({mesh.data})")
        rows = M.shard_batch({"ids": prompt_ids, "mask": prompt_mask},
                             mesh)
        if vision is not None:
            vision = M.shard_batch({"v": vision}, mesh)["v"]
        if isinstance(generator, (list, tuple)):
            generator = M.shard_batch({"g": list(generator)}, mesh)["g"]
        elif generator is not None and mesh.data > 1:
            generator = data_rank_generator(generator, mesh)
        out = self.program(vision, rows["ids"], rows["mask"], generator)
        return M.all_gather_cat(out, mesh.data_group, 0)


def data_rank_generator(generator: torch.Generator, mesh: M.Mesh
                        ) -> torch.Generator:
    """The data rank's stream: a seed drawn from ``generator`` (the same
    draw on every rank) folded with the data rank
    (``utils.random.step_generator``)."""
    seed = int(torch.randint(2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return step_generator(seed, mesh.data_rank, generator.device)


def make_sharded_generate_fn(mllm, cfg: SamplingConfig, max_new_tokens: int,
                             prompt_len: int, eos_id: int, mesh: M.Mesh,
                             pad_id: int = 0, fsdp: bool = False,
                             fsdp_min_size: Optional[int] = None,
                             early_exit_chunk: Optional[int] = 8,
                             quantize_decode: bool = False,
                             quantize_kv: bool = False,
                             speculative: bool = False,
                             spec_window: int = 8,
                             fused_head: bool = False):
    """A generator ``(vision, prompt_ids, prompt_mask, generator) -> (B,
    max_new_tokens) int32`` over ``mesh``, from ``mllm``, a one-process
    ``MultiModalLLM`` (its weights are the JAX function's ``variables``).
    The batch must divide the data axis.  Returns ``(generate,
    local_mllm)``: the rank's placed shard, built here on
    ``mesh.device``.  A sampled speculative program takes a list of one
    CPU generator per global row; every other program one generator."""
    from tsue_tpu_torch.eval.generation import make_generate_fn
    from tsue_tpu_torch.eval.speculative import make_speculative_generate_fn
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    llama = mllm.llama
    args = (llama.cfg, mllm.qformer.cfg if mllm.use_vision else None,
            mllm.use_vision, llama.dtype)
    local = place(lambda m: MultiModalLLM(*args, mesh=m), mllm.state_dict(),
                  mesh, fsdp, fsdp_min_size, quantize_decode, fused_head)
    if speculative:
        prog = make_speculative_generate_fn(
            local, cfg, max_new_tokens, prompt_len, eos_id, pad_id,
            window=spec_window, quantize_kv=quantize_kv)
    else:
        prog = make_generate_fn(local, cfg, max_new_tokens, prompt_len,
                                eos_id, pad_id, early_exit_chunk,
                                fused_head=fused_head,
                                quantize_kv=quantize_kv)
    return ShardedProgram(prog, mesh), local


def load_shards(module, state: Mapping[str, torch.Tensor], mesh: M.Mesh
                ) -> None:
    """Load this rank's shards of the one-process ``state`` into the
    local-shard ``module`` strictly, each parameter taking its entry's
    dtype (a bf16 state serves in bf16)."""
    shards = shard_state(state, mesh)
    for name, p in module.named_parameters():
        t = shards.get(name)
        if t is not None and t.is_floating_point() and t.dtype != p.dtype:
            p.data = p.data.to(t.dtype)
    module.load_state_dict(shards, strict=True)
