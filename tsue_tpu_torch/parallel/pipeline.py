"""Pipeline parallelism (GPipe) over the Llama decoder depth, over
``torch.distributed``.

Counterpart of ``tsue_tpu/parallel/pipeline.py``.  The JAX package runs
the schedule as one ``shard_map`` program: a ``lax.scan`` over ticks in
which every stage applies its stacked layers and hands the result on by a
circular ``ppermute``, autodiff turning the hops around for the backward.
The port writes the schedule out, one process a stage:

- ``make_pipeline_mesh(pp)``: the JAX layout, data outer and pipe inner
  (``pipeline.py:55-65``): rank ``r`` is stage ``r % pp`` of data rank
  ``r // pp``; a pipe group is ``pp`` consecutive ranks, a data group the
  ranks of one stage.  There is no model axis: as in the JAX package the
  pipeline composes with data parallelism only.
- ``split_llama_layers``/``join_llama_layers``: pure functions over state
  dicts.  The port's names are the global Flax paths
  (``llama.model.layer_{i}.…``), so a split is a filter by layer index
  and a join a union; there is no (S, L/S, …) stacking, which served only
  ``lax.scan``.  ``stage_state`` is one stage's share: its L/S layers and
  the whole outer part (the fusion front-end, the embedding, the final
  norm, the head), which every stage holds.  ``stage_of`` builds a
  stage's model from a whole one, ``gather_stages`` joins the stages'
  layers back on every rank of a pipe group.
- ``pipelined_lm_loss``: the stage-1 LM loss (``MultiModalLLM.lm_loss``)
  under GPipe over M microbatches of the data rank's rows
  (``pipeline.py:121-274``).  Forward, in microbatch order: stage 0 fuses
  microbatch m (the front-end), every other stage receives it from stage
  s - 1; each applies its layers and sends the result to s + 1; the last
  stage applies the final norm, the head and the masked CE sum
  (``cfg.loss_chunk`` honoured).  The fused mask and the positions come
  from the batch on every stage (``ones(n_img) ‖ attention_mask`` and its
  cumulative count), without the front-end.  Backward, in reverse
  microbatch order: each stage receives the output gradient from s + 1,
  runs autograd and sends the input gradient to s - 1.  Both sides post
  every transfer in this one order, so the schedule cannot deadlock.  The
  loss is the CE sum over the global valid-token count (all-reduced over
  data), so its gradient is the global token mean's; every rank returns
  the same value.
- ``make_pipelined_stage1_step`` (``pipeline.py:289-322``): the train
  step (the loss and its backward; the outer part's gradients summed over
  the pipe group, where the tied embedding's contributions from stage 0
  and the last stage merge, the JAX ``psum``; then every gradient summed
  over data; then ``GuardedAdamW``, whose guard and clip read the global
  gradient) and the eval step (the deterministic forward).

Dropout draws from an explicit generator per (seed, step, data rank,
stage, microbatch), as the JAX package folds the same indices into its key
(``pipeline.py:181``, ``:223-224``); its masks cannot be JAX's, so parity
holds at dropout 0.  ``cfg.remat`` applies to a stage's layers.  The
transfers are ``parallel.mesh``'s ``isend``/``irecv``: direct under NCCL,
through a pinned host buffer for a CUDA tensor under gloo (two ranks on
one card).

``torch.distributed.pipelining`` is not used: its sends go through
``batch_isend_irecv``, which gloo cannot run on CUDA tensors, and it splits
a model by tracing.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from tsue_tpu_torch.parallel import mesh as M
from tsue_tpu_torch.utils.random import step_generator

IGNORE_LABEL = -100
_LAYER = re.compile(r"(?:^|\.)llama\.model\.layer_(\d+)\.")


def layer_index(name: str) -> Optional[int]:
    """The decoder layer a parameter name belongs to, or None (the outer
    part)."""
    m = _LAYER.search(name)
    return int(m.group(1)) if m else None


def _renamed(name: str, layer: int) -> str:
    m = _LAYER.search(name)
    return name[:m.start(1)] + str(layer) + name[m.end(1):]


def make_pipeline_mesh(pipeline_parallel: int, device="cuda") -> M.Mesh:
    """The ``(data, pipe)`` mesh over the process group (one process
    without one): ``parallel.mesh.make_mesh``'s layout with the pipe axis
    where its model axis would be.  ``pipeline_parallel`` must divide the
    world size; every rank must call it, in the same order as its other
    group creations."""
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    pp = pipeline_parallel
    if pp < 1 or world % pp:
        raise ValueError(f"pipeline_parallel={pp} must divide the world "
                         f"size {world}")
    m = M.make_mesh(pp, device)
    return dataclasses.replace(m, model=1, model_rank=0, model_group=None,
                               pipe=m.model, pipe_rank=m.model_rank,
                               pipe_group=m.model_group)


# ---------------------------------------------------------------------------
# The weights of the stages
# ---------------------------------------------------------------------------

def stage_layers(num_layers: int, n_stages: int, stage: int) -> range:
    """The decoder layers of ``stage``: L / S consecutive ones."""
    if num_layers % n_stages:
        raise ValueError(f"num_layers={num_layers} must divide into "
                         f"{n_stages} pipeline stages")
    per = num_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def split_llama_layers(state: Mapping[str, torch.Tensor], n_stages: int
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  List[Dict[str, torch.Tensor]]]:
    """A MultiModalLLM's state dict -> (outer, layers): ``outer`` every
    entry outside the decoder layers, ``layers[s]`` stage s's layers under
    their global names (``pipeline.py:72-94``).  Raises where the layer
    count does not divide into ``n_stages``."""
    ids = [layer_index(k) for k in state]
    L = max((i for i in ids if i is not None), default=-1) + 1
    per = len(stage_layers(L, n_stages, 0))
    outer = {k: v for k, v, i in zip(state, state.values(), ids) if i is None}
    layers: List[Dict[str, torch.Tensor]] = [{} for _ in range(n_stages)]
    for k, v, i in zip(state, state.values(), ids):
        if i is not None:
            layers[i // per][k] = v
    return outer, layers


def join_llama_layers(outer: Mapping[str, torch.Tensor],
                      layers: List[Mapping[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`split_llama_layers`: the union, the one
    process's state (``pipeline.py:97-108``)."""
    out = dict(outer)
    for part in layers:
        out.update(part)
    return out


def stage_state(state: Mapping[str, torch.Tensor], n_stages: int,
                stage: int) -> Dict[str, torch.Tensor]:
    """Stage ``stage``'s share of a whole state: the outer part and its
    layers."""
    outer, layers = split_llama_layers(state, n_stages)
    return join_llama_layers(outer, [layers[stage]])


def stage_of(mllm, mesh: M.Mesh):
    """This rank's stage of ``mesh`` built from a whole (one-process)
    ``MultiModalLLM``: a MultiModalLLM on ``mesh.device`` holding the
    stage's layers under their global names and the whole outer part, with
    ``mllm``'s weights."""
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    cfg = mllm.llama.cfg
    with torch.device(mesh.device):
        stage = MultiModalLLM(
            cfg, mllm.qformer.cfg if mllm.use_vision else None,
            mllm.use_vision, mllm.llama.dtype,
            layers=stage_layers(cfg.num_layers, mesh.pipe, mesh.pipe_rank))
    stage.load_state_dict(stage_state(mllm.state_dict(), mesh.pipe,
                                      mesh.pipe_rank))
    return stage


def gather_stages(stage, mesh: M.Mesh, device=None
                  ) -> Dict[str, torch.Tensor]:
    """The whole MLLM's state, in the one process's names, on every rank
    of the stage's pipe group: each layer entry all-gathered over the
    group (the stages hold equal shapes in one order), then joined with
    the outer part.  ``device``: where the joined tensors go (the stage's
    own by default; ``"cpu"`` joins on the host, one entry's gather on
    the device at a time).  A collective of the pipe group."""
    def put(t):
        return t if device is None else t.to(device)

    state = {k: v.detach() for k, v in stage.state_dict().items()}
    if mesh.pipe == 1:
        return {k: put(v) for k, v in state.items()}
    outer = {k: put(v) for k, v in state.items() if layer_index(k) is None}
    ids = stage.llama.model.layer_ids
    per = len(ids)
    layers: List[Dict[str, torch.Tensor]] = [{} for _ in range(mesh.pipe)]
    for k, v in state.items():
        i = layer_index(k)
        if i is None:
            continue
        parts = M.all_gather_cat(v.unsqueeze(0), mesh.pipe_group, 0)
        for s in range(mesh.pipe):
            layers[s][_renamed(k, s * per + i - ids[0])] = put(parts[s])
    return join_llama_layers(outer, layers)


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

def _microbatches(batch: Mapping[str, torch.Tensor], n: int) -> List[Dict]:
    B = batch["input_ids"].shape[0]
    if B % n:
        raise ValueError(f"the data rank's batch {B} must be divisible by "
                         f"the microbatches {n}")
    bm = B // n
    return [{k: v[m * bm:(m + 1) * bm] for k, v in batch.items()}
            for m in range(n)]


def pipelined_lm_loss(stage, mesh: M.Mesh, batch: Mapping[str, torch.Tensor],
                      num_microbatches: int,
                      generators: Optional[List[torch.Generator]] = None,
                      backward: bool = False) -> torch.Tensor:
    """The stage-1 LM loss of the data rank's rows ``batch`` (``vision``
    optional, ``input_ids``, ``attention_mask``, ``labels``) under the
    GPipe schedule over ``num_microbatches`` (module docstring), with
    ``stage`` this rank's stage of ``mesh``.  ``generators`` (one per
    microbatch) drop; none is the deterministic forward.  ``backward``
    also runs the backward, leaving this stage's parameter gradients in
    ``.grad`` (not yet summed over pipe or data).  Returns the global loss
    (detached), the same on every rank.  A collective of the mesh."""
    S, s = mesh.pipe, mesh.pipe_rank
    first, last = s == 0, s == S - 1
    group = mesh.pipe_group
    prev = None if first else dist.get_global_rank(group, s - 1)
    nxt = None if last else dist.get_global_rank(group, s + 1)
    mbs = _microbatches(batch, num_microbatches)
    vision = batch.get("vision")
    n_img = (stage.qformer.cfg.num_query_tokens
             if stage.use_vision and vision is not None else 0)
    dev = batch["input_ids"].device
    masks, labels = [], []
    for mb in mbs:
        am, lab = mb["attention_mask"], mb["labels"]
        if n_img:
            bm = am.shape[0]
            am = torch.cat([torch.ones(bm, n_img, dtype=am.dtype, device=dev),
                            am], 1)
            lab = torch.cat([torch.full((bm, n_img), IGNORE_LABEL,
                                        dtype=lab.dtype, device=dev), lab], 1)
        masks.append(am)
        labels.append(lab)
    count = sum((lab[:, 1:] != IGNORE_LABEL).sum() for lab in labels).float()
    count = M.all_reduce(count, mesh.data_group).clamp_min(1)
    embed = stage.llama.model.embed_tokens.weight
    act_dtype = torch.promote_types(embed.dtype,
                                    stage.text_modality_embedding.dtype)
    D = stage.llama.cfg.hidden_size

    ins, outs, sends = [], [], []
    total = torch.zeros((), device=dev)
    for m, mb in enumerate(mbs):
        gen = None if generators is None else generators[m]
        x_in = None
        if first:
            x, _, _ = stage.fuse(mb.get("vision"), mb["input_ids"],
                                 mb["attention_mask"], gen)
        else:
            x_in = torch.empty(masks[m].shape + (D,), dtype=act_dtype,
                               device=dev)
            M.irecv(x_in, prev, group).wait()
            x = x_in.requires_grad_(backward)
        y = stage.llama.model(x, masks[m], generator=gen, normed=False)
        if last:
            ce, _ = stage.llama.ce_sum(stage.llama.model.final_norm(y),
                                       labels[m])
            y = ce / count
            total = total + y.detach()
        else:
            sends.append(M.isend(y.detach(), nxt, group))
        ins.append(x_in)
        outs.append(y if backward else None)
    for t in sends:
        t.wait()

    if backward:
        sends = []
        for m in reversed(range(len(mbs))):
            if last:
                torch.autograd.backward(outs[m])
            else:
                g = torch.empty_like(outs[m])
                M.irecv(g, nxt, group).wait()
                torch.autograd.backward(outs[m], g)
            outs[m] = None
            if not first:
                sends.append(M.isend(ins[m].grad, prev, group))
            ins[m] = None
        for t in sends:
            t.wait()
    # only the last stage holds the sum: the JAX psum over pipe, then data
    total = M.all_reduce(total, group)
    return M.all_reduce(total, mesh.data_group)


def _sum_grads(params: List[torch.nn.Parameter], group) -> None:
    """Sum the gradients of ``params`` over ``group`` in place: one
    all-reduce a dtype over their concatenation."""
    if group is None or not params:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = M.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


def microbatch_generators(mesh: M.Mesh, num_microbatches: int, seed: int,
                          step: int, device) -> List[torch.Generator]:
    """The dropout generators of a train step's microbatches on this rank:
    ``step_generator(seed, step)``'s stream folded with the data rank, the
    stage and the microbatch (``tsue_tpu/parallel/pipeline.py:181``,
    ``:223-224``)."""
    n = num_microbatches
    base = n * (mesh.pipe_rank + mesh.pipe * mesh.data_rank)
    return [step_generator(seed, step, device, stream=1 + base + m)
            for m in range(n)]


def make_pipelined_stage1_step(mesh: M.Mesh, num_microbatches: int
                               ) -> Tuple[Callable, Callable]:
    """``(train_step, eval_step)`` of the pipelined stage-1 fine-tune.

    ``train_step(state, batch, seed, step) -> {"lm_loss"}`` updates
    ``state`` (``TrainState`` over this rank's stage, its optimizer from
    ``train.stage1.make_stage1_optimizer(cfg, stage, mesh=mesh)``) in
    place; microbatch m drops from ``microbatch_generators``.
    ``eval_step(state, batch) -> {"lm_loss"}`` is the deterministic
    forward.  ``batch`` is the data rank's rows."""
    n = num_microbatches

    def train_step(state, batch: Dict[str, torch.Tensor], seed: int,
                   step: int) -> Dict:
        opt = state.optimizer
        opt.zero_grad()
        loss = pipelined_lm_loss(
            state.model, mesh, batch, n, microbatch_generators(
                mesh, n, seed, step, batch["input_ids"].device),
            backward=True)
        for p in opt.params:
            if p.grad is None:      # a trainable parameter off this stage's
                p.grad = torch.zeros_like(p)    # path: a zero gradient
        _sum_grads([p for p, own in zip(opt.params, opt.stage_own)
                    if not own], mesh.pipe_group)
        _sum_grads(opt.params, mesh.data_group)
        opt.step()
        state.step += 1
        return {"lm_loss": loss}

    @torch.no_grad()
    def eval_step(state, batch: Dict[str, torch.Tensor]) -> Dict:
        return {"lm_loss": pipelined_lm_loss(state.model, mesh, batch, n)}

    return train_step, eval_step
