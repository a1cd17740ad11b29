"""The process mesh and its collectives over ``torch.distributed``.

Counterpart of ``tsue_tpu/parallel/mesh.py``.  The reference's runtime is
torchrun + DDP/NCCL with a ``DistributedSampler`` (ref
scripts/train.py:1044-1049); the JAX package replaces it with one
controller over a ``("data", "model")`` device mesh whose collectives XLA
inserts.  The port goes back to the reference's form: one process per
device, as torchrun launches them, each holding its own shard as plain
tensors, with every collective written out here.

- ``make_mesh(model_parallel)`` lays the world out as the JAX package
  reshapes its devices, ``(data, model)`` row-major: rank ``r`` has data
  rank ``r // model`` and model rank ``r % model``; the model group of a
  data rank is its ``model`` consecutive ranks, the data group of a model
  rank every ``model``-th rank.  ``parallel.pipeline.make_pipeline_mesh``
  lays out ``(data, pipe)`` the same way (``Mesh.pipe``).
- ``initialize_distributed(backend)`` reads torchrun's contract and joins
  the process group; the caller names the backend (NCCL for one GPU a
  rank, gloo on the CPU and for two ranks sharing one card).
  ``join_torchrun(device)`` is the commands' join: the backend from the
  device, and on the card rank 0 building the kernels before the others
  load them.
- The collective helpers (``all_reduce``, ``all_gather_cat``,
  ``broadcast``, the object forms), the point-to-point ``isend`` and
  ``irecv`` (the pipeline's activations and their gradients) and the
  three autograd Functions of Megatron's tensor parallelism
  (``copy_to_model``, ``reduce_from_model``, ``gather_from_model``) are
  what the port's modules call.

Gloo on CUDA tensors.  NCCL refuses two ranks on one device
(``ncclInvalidUsage``), so two ranks sharing a card run over gloo.  Gloo
takes CUDA tensors for all-reduce, broadcast and all-gather, the only
tensor collectives this module issues (``GLOO_CUDA_OPS``; found on an H100
with PyTorch 2.11, where reduce-scatter and all-to-all ran too), so those
are never staged through the host; a CUDA tensor in a gloo group for any
other collective raises.  A point-to-point send of a CUDA tensor failed
there (``writev: Bad address``), so ``isend``/``irecv`` carry a CUDA
tensor in a gloo group through a pinned host buffer, which the receiver
copies back onto its device: the one transfer staged through the host,
counted apart (``send_staged``, ``recv_staged`` and their bytes).  Under
NCCL, and for CPU tensors, a send goes directly.  ``COUNTS`` counts every
collective and transfer of this module by kind; FSDP2's own all-gathers
and reduce-scatters are not counted here.

Not ported: the TPU-VM heuristics of the JAX module (the metadata-server
and device-file probes of ``_on_tpu_vm``): the port is started by torchrun,
whose environment says everything.
"""
from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# the tensor collectives this module issues, each of which gloo runs on
# CUDA tensors itself
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})

COUNTS: Counter = Counter()

TORCHRUN_KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def reset_counts() -> None:
    COUNTS.clear()


@dataclass
class Mesh:
    """A ``(data, model)`` or ``(data, pipe)`` layout of the world and
    this rank's place in it.  ``data_group``/``model_group``/``pipe_group``
    are None where the axis has size 1 (nothing to talk to)."""
    data: int = 1
    model: int = 1
    rank: int = 0
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    _device_mesh: object = None
    # the pipeline's stages (``parallel.pipeline``): this rank's stage
    pipe: int = 1
    pipe_rank: int = 0
    pipe_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model, "pipe": self.pipe}

    @property
    def size(self) -> int:
        return self.data * self.model * self.pipe

    def is_primary(self) -> bool:
        return self.rank == 0

    def data_device_mesh(self):
        """The data axis as a ``torch.distributed`` DeviceMesh (FSDP2's
        argument), built on first use."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            ranks = [d * self.model + self.model_rank
                     for d in range(self.data)]
            self._device_mesh = DeviceMesh.from_group(
                self.data_group, self.device.type, mesh=ranks,
                mesh_dim_names=("data",))
        return self._device_mesh


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(backend: str) -> bool:
    """Join the process group that torchrun describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) over
    ``backend``; returns whether the process is now one of several.

    Without ``WORLD_SIZE`` in the environment the process runs alone and
    nothing is joined.  With it, every key must be present and the init
    must succeed: a failure raises instead of running on as a silent
    one-process job that would write checkpoints over the others' (the
    JAX package's policy, ``tsue_tpu/parallel/mesh.py:174-181``).  A
    group already joined is kept, and must use ``backend``."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f", not the {backend} asked for")
        return dist.get_world_size() > 1
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in TORCHRUN_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: launch "
                           "with torchrun (python -m torch.distributed.run)")
    if backend == "nccl":
        torch.cuda.set_device(_local_rank())
    try:
        dist.init_process_group(
            backend, init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                                  f"{os.environ['MASTER_PORT']}"),
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    except Exception as e:
        raise RuntimeError(
            "torchrun's environment asks for a process group but "
            f"init_process_group({backend!r}) failed; refusing to continue "
            f"as a one-process job: {e}") from e
    return dist.get_world_size() > 1


def join_torchrun(device) -> bool:
    """Join torchrun's process group, unless one is joined, with the
    backend of ``device``'s type: gloo on the CPU, NCCL on the card.  On
    the card rank 0 then builds every kernel and the others wait, so no
    two ranks compile at once.  Returns whether the process is one of
    several."""
    if not (dist.is_available() and dist.is_initialized()):
        cpu = torch.device(device).type == "cpu"
        if initialize_distributed("gloo" if cpu else "nccl") and not cpu:
            if is_primary():
                from tsue_tpu_torch.ops._build import CSRC, build_all
                build_all(sorted(f.stem for f in CSRC.glob("*.cu")))
            barrier()
    return distributed()


def leave_distributed() -> None:
    """Leave the process group, where one was joined: a barrier, so that
    no rank closes its transport while another still uses it, then
    ``destroy_process_group``, so that the backend's threads are joined
    before the interpreter exits.  A gloo rank left to exit with its group
    alive can abort after its work is done ("terminate called without an
    active exception")."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh runs on the CUDA device by default "
                               "and none is available; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", _local_rank())
    return dev


def make_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """The ``(data, model)`` mesh over the process group (one process
    without one), its subgroups on the process group's backend.
    ``model_parallel`` must divide the world size
    (``tsue_tpu/parallel/mesh.py:27-29``).  ``device`` is this rank's
    device (``"cuda"`` is ``cuda:$LOCAL_RANK``).  Every rank must call it,
    in the same order as its other group creations."""
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the "
                         f"world size {world}")
    if world == 1:
        return Mesh(device=_resolve_device(device))
    rank = dist.get_rank()
    tp = model_parallel
    dp = world // tp
    mine = {}
    # every rank creates every group, in one order
    for d in range(dp):
        ranks = list(range(d * tp, (d + 1) * tp))
        g = dist.new_group(ranks) if tp > 1 else None
        if rank in ranks:
            mine["model"] = g
    for m in range(tp):
        ranks = list(range(m, world, tp))
        g = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            mine["data"] = g
    return Mesh(data=dp, model=tp, rank=rank, data_rank=rank // tp,
                model_rank=rank % tp, data_group=mine["data"],
                model_group=mine["model"],
                device=_resolve_device(device))


def shard_batch(batch: Dict, mesh: Optional[Mesh]) -> Dict:
    """This rank's rows of a global batch (arrays or tensors with a
    leading batch axis): the ``data_rank``-th of ``mesh.data`` contiguous
    slices, so the data ranks' rows in rank order are the global batch."""
    if mesh is None or mesh.data == 1:
        return batch
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % mesh.data:
            raise ValueError(f"batch {B} ({k}) must divide the data axis "
                             f"({mesh.data})")
        n = B // mesh.data
        out[k] = v[mesh.data_rank * n:(mesh.data_rank + 1) * n]
    return out


def is_primary(mesh: Optional[Mesh] = None) -> bool:
    """Rank-0 gating (ref ``local_rank == 0``, scripts/train.py:1219)."""
    if mesh is not None:
        return mesh.is_primary()
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def barrier() -> None:
    """Cross-process sync (ref ``dist.barrier``, check_generation.py:369);
    nothing in one process."""
    if distributed():
        COUNTS["barrier"] += 1
        dist.barrier()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _collective(kind: str, group, t: torch.Tensor, run):
    """``run(t)``, counted.  A CUDA tensor in a gloo group raises for a
    kind that gloo does not run on CUDA tensors (module docstring)."""
    if t.is_cuda and kind not in GLOO_CUDA_OPS \
            and dist.get_backend(group) == "gloo":
        raise RuntimeError(f"gloo does not run {kind} on CUDA tensors")
    COUNTS[kind] += 1
    return run(t)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """Sum (``op``) ``t`` over ``group`` in place; returns ``t``."""
    if group is None:
        return t

    def run(x):
        dist.all_reduce(x, op=op, group=group)
        return x
    return _collective("all_reduce", group, t, run)


def broadcast(t: torch.Tensor, group, src_rank_in_group: int = 0
              ) -> torch.Tensor:
    """``t`` from the group's ``src_rank_in_group``-th rank, in place."""
    if group is None:
        return t

    def run(x):
        dist.broadcast(x, dist.get_global_rank(group, src_rank_in_group),
                       group=group)
        return x
    return _collective("broadcast", group, t, run)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    group rank order."""
    if group is None:
        return t

    def run(x):
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)
    return _collective("all_gather", group, t.contiguous(), run)


def all_gather_object(obj, group=None) -> List:
    """Every rank's ``obj`` in group rank order (pickled: no staging)."""
    if not distributed():
        return [obj]
    COUNTS["all_gather_object"] += 1
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (the HTTP server's request
    broadcast)."""
    if not distributed():
        return obj
    COUNTS["broadcast_object"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_reduce_scalars(values, group, device) -> np.ndarray:
    """Sum a few float64 scalars over ``group`` (metrics)."""
    t = torch.tensor(np.asarray(values, np.float64), device=device)
    return all_reduce(t, group).cpu().numpy()


# ---------------------------------------------------------------------------
# Point-to-point transfers
# ---------------------------------------------------------------------------

class Transfer:
    """A posted send or receive.  ``wait()`` completes it; a staged
    receive then copies its host buffer onto the device.  The buffers
    live until then."""

    def __init__(self, work, buf: torch.Tensor,
                 dest: Optional[torch.Tensor] = None):
        self.work, self.buf, self.dest = work, buf, dest

    def wait(self) -> None:
        self.work.wait()
        if self.dest is not None:
            self.dest.copy_(self.buf)
        self.buf = self.dest = None


def _staged(t: torch.Tensor, group, kind: str) -> Optional[torch.Tensor]:
    """The pinned host buffer of a transfer that gloo cannot make from a
    CUDA tensor (module docstring), counted with its bytes; None where
    the transfer goes directly, counted as ``kind``."""
    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        COUNTS[kind] += 1
        return None
    COUNTS[f"{kind}_staged"] += 1
    COUNTS[f"{kind}_staged_bytes"] += t.numel() * t.element_size()
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def isend(t: torch.Tensor, dst: int, group=None) -> Transfer:
    """Post a send of ``t`` to global rank ``dst`` of ``group``.  The
    caller keeps ``t`` unchanged until the transfer is waited on."""
    t = t.contiguous()
    buf = _staged(t, group, "send")
    if buf is None:
        return Transfer(dist.isend(t, dst, group=group), t)
    buf.copy_(t)       # synchronous: on the host before the send is posted
    return Transfer(dist.isend(buf, dst, group=group), buf)


def irecv(t: torch.Tensor, src: int, group=None) -> Transfer:
    """Post a receive into ``t`` (contiguous) from global rank ``src`` of
    ``group``; ``t`` holds the data once the transfer is waited on."""
    buf = _staged(t, group, "recv")
    if buf is None:
        return Transfer(dist.irecv(t, src, group=group), t)
    return Transfer(dist.irecv(buf, src, group=group), buf, t)


# ---------------------------------------------------------------------------
# Megatron's tensor-parallel Functions
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward: in front of a column-split
    product, whose input gradient is a partial sum on each model rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward: after a row-split product
    (its output a partial sum on each model rank).  Not
    ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces too and so multiplies the replicated gradient by the
    model degree."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather forward along ``dim``, this rank's slice backward: a
    feature-split activation made whole (the embedding's lookup); the
    gradient that reaches it is the same whole tensor on every model
    rank."""

    @staticmethod
    def forward(ctx, x, group, dim, rank, n):
        ctx.dim, ctx.rank, ctx.n = dim, rank, n
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None, \
            None, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.model == 1 or not torch.is_grad_enabled():
        return x
    return _Copy.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]
                      ) -> torch.Tensor:
    if mesh is None or mesh.model == 1:
        return x
    if not torch.is_grad_enabled():
        return all_reduce(x.contiguous().clone(), mesh.model_group)
    return _Reduce.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, mesh: Optional[Mesh], dim: int = -1
                      ) -> torch.Tensor:
    if mesh is None or mesh.model == 1:
        return x
    dim = dim % x.dim()
    if not torch.is_grad_enabled():
        return all_gather_cat(x, mesh.model_group, dim)
    return _Gather.apply(x, mesh.model_group, dim, mesh.model_rank,
                         mesh.model)
