"""Process groups and the (data × model) mesh: data parallelism over
processes and the tensor-parallel classifier head.

The counterpart of the JAX package's ``x3d_tpu/parallel/mesh.py``, in
PyTorch's idiom: one process per GPU, ``torch.distributed`` (NCCL on CUDA,
gloo on the CPU), and a mesh of two axes over the processes:

* ``data``: each data rank takes a contiguous slice of the global batch
  (:func:`shard_batch`); gradients are averaged over the data group after
  the backward pass, and with ``TPU.SYNC_BN: True`` every BatchNorm's
  batch statistics are all-reduced over it (global statistics).
* ``model``: the head's fc_1 is split by output columns and fc_2 by input
  rows over the model group (the JAX package's ``_param_spec``); the
  2048-wide activation stays split between them and one all-reduce of the
  partial logits joins them (:func:`copy_to_model`,
  :func:`reduce_from_model`).  Everything else is replicated.

Rank ``r`` sits at ``(r // model, r % model)``, as the JAX package reshapes
its device list to (data, model): the model ranks of a data group are
consecutive and see the same batch.

The gradients are reduced by the train step itself
(``train/steps.py``), in one coalesced float32 buffer averaged over the
data group that also carries the step's metrics and, with per-replica BN,
the running statistics -- not by ``DistributedDataParallel``, which by
default broadcasts rank 0's buffers (the BN running statistics) at every
forward, which is wrong for ``SYNC_BN: False``, and which wraps the model
that ``train_step`` checks is its state's own.

The collectives are ``all_reduce`` and ``broadcast`` only: gloo has no
``all_gather`` for CUDA tensors, and two processes may share one card over
gloo (NCCL refuses two ranks on one device).  Process-group setup reads
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``), as ``jax.distributed.initialize()`` reads
its cluster's; ``rank``, ``world_size``, ``init_method`` and ``backend``
may be given instead.  A CUDA run that cannot form its NCCL group raises;
nothing falls back to gloo or to one process.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from x3d_tpu_torch.utils import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(eq=False)
class Mesh:
    """This process's place on a (data × model) mesh of processes.

    ``data_group`` and ``model_group`` are this rank's process groups
    (None without a process group: one process, nothing to reduce)."""
    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    backend: Optional[str] = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that logs and writes checkpoints."""
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def data_root(self) -> int:
        """The global rank of data rank 0 in this rank's data group."""
        return self.model_rank

    def __deepcopy__(self, memo):
        # a copied model stays on the same mesh (process groups do not copy)
        return self


def layout(world: int, data: int = -1, model: int = 1):
    """(data, model) for ``world`` processes; ``data = -1`` is ``world //
    model``.  Raises where the product is not the world."""
    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if data == -1:
        if world % model:
            raise ValueError(f"{world} processes not divisible by "
                             f"model={model}")
        data = world // model
    if data < 1 or data * model != world:
        raise ValueError(f"mesh data={data} x model={model} needs "
                         f"{data * model} processes, have {world}")
    return data, model


def in_torchrun() -> bool:
    """Whether torchrun's (or another launcher's) environment is set."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_mesh(data: int = -1, model: int = 1, *, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              local_rank: Optional[int] = None,
              init_method: Optional[str] = None,
              backend: Optional[str] = None, device=None,
              timeout: datetime.timedelta = TIMEOUT) -> Mesh:
    """Join (or create) the default process group and build the mesh.

    ``rank``, ``world_size`` and ``local_rank`` default to torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``init_method`` to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).  The device is
    ``cuda:LOCAL_RANK`` unless ``device`` is given; a node with fewer cards
    than local ranks raises.  The backend is NCCL on CUDA and gloo on the
    CPU unless ``backend`` is given (two ranks sharing one card must pass
    gloo and the device).  Every rank calls this with the same layout.
    """
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None \
        else local_rank
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "ranks on the CPU")
        cards = torch.cuda.device_count()
        if local_rank >= cards:
            raise RuntimeError(
                f"local rank {local_rank} has no card: this node has "
                f"{cards}; start at most {cards} processes a node or pass "
                "a device")
        device = torch.device("cuda", local_rank)
    else:
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    data, model = layout(world_size, data, model)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size,
                                timeout=timeout)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
        raise RuntimeError(
            f"the process group has rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, the mesh wants {rank} of {world_size}")
    # every rank creates every group, in the same order
    data_group = model_group = None
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        g = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            data_group = g
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        g = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            model_group = g
    return Mesh(data, model, rank, device, data_group, model_group, backend)


def mesh_from_config(cfg, **kwargs) -> Mesh:
    """:func:`init_mesh` with the config's ``TPU.MESH_DATA`` and
    ``TPU.MESH_MODEL``."""
    return init_mesh(cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL, **kwargs)


def shutdown() -> None:
    """Leave the default process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(mesh: Optional[Mesh]) -> None:
    """All ranks meet (nothing without a process group)."""
    if mesh is not None and mesh.distributed:
        if mesh.backend == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()


# ------------------------------------------------------------ collectives


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the cotangents over it too
    (each rank's loss depends on the sum of every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: the replicated input of a
    column-split layer, whose cotangent is the sum of every shard's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial outputs of a
    row-split layer, summed; every shard's cotangent is the sum's."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (identity without one)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def _coalesced_(tensors: Sequence[torch.Tensor], collective) -> None:
    """Run ``collective`` on one flat buffer of ``tensors`` (one dtype, one
    device) and copy the result back into them."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group,
                     size: int) -> None:
    """Average ``tensors`` (float32, one device) over ``group`` in place, in
    one coalesced all-reduce."""
    def mean_(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(size)

    if group is not None and tensors:
        _coalesced_(tensors, mean_)


def broadcast_(tensors: Sequence[torch.Tensor], group, src: int) -> None:
    """Broadcast ``tensors`` (one dtype, one device) from global rank
    ``src`` over ``group`` in place, in one coalesced call."""
    if group is not None and tensors:
        _coalesced_(tensors, lambda flat: dist.broadcast(flat, src=src,
                                                         group=group))


# ------------------------------------------------------------ batches


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh,
                clips_per_sample: int = 1) -> Dict[str, torch.Tensor]:
    """This data rank's contiguous slice of a global batch, as the JAX
    package's ``batch_sharding`` splits the leading axis: samples ``[r *
    B/W, (r + 1) * B/W)`` of ``label`` and their clips of ``video``
    (``clips_per_sample`` clips a sample, clip-major, as eval batches carry
    their views).  Raises where the batch does not divide."""
    B = batch["label"].shape[0]
    if B % mesh.data:
        raise ValueError(f"batch {B} not divisible by {mesh.data} data "
                         "ranks")
    n = B // mesh.data
    lo = mesh.data_rank * n
    return {"video": batch["video"][lo * clips_per_sample:
                                    (lo + n) * clips_per_sample],
            "label": batch["label"][lo:lo + n]}


def local_batch(global_batch: int, mesh: Optional[Mesh]) -> int:
    """A data rank's share of a global batch: ``global_batch // data``
    (``x3d_tpu/tools/train.py:154``); raises where it does not divide."""
    if mesh is None or mesh.data == 1:
        return global_batch
    if global_batch % mesh.data:
        raise ValueError(f"batch {global_batch} not divisible by "
                         f"{mesh.data} data ranks")
    return global_batch // mesh.data


# ------------------------------------------------------------ model state


def sync_state_(model, mesh: Optional[Mesh]) -> None:
    """Make every data rank's parameters and buffers those of data rank 0
    (one broadcast over the data group), so the ranks start alike whatever
    each drew (ranks that drew from one seed hold the same values
    already)."""
    if mesh is None or not mesh.distributed or mesh.data == 1:
        return
    with torch.no_grad():
        tensors = [t for t in [*model.parameters(), *model.buffers()]
                   if t.dtype == torch.float32]
        broadcast_(tensors, mesh.data_group, mesh.data_root())


def gather_split(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The full tensor of a shard split along ``dim`` over the model group:
    each rank writes its shard into zeros and the model group sums them
    (``all_reduce`` only, see the module docstring)."""
    shape = list(t.shape)
    w = shape[dim]
    shape[dim] = w * mesh.model
    full = t.new_zeros(shape)
    full.narrow(dim, mesh.model_rank * w, w).copy_(t)
    dist.all_reduce(full, group=mesh.model_group)
    return full


def cut_split(full: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's shard of a full tensor."""
    w = full.shape[dim] // mesh.model
    return full.narrow(dim, mesh.model_rank * w, w).clone()


def full_model_state(model) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with the head's shards joined into full
    tensors: a collective over the model group where the head is split, so
    every rank calls it.  Checkpoints hold full tensors, whatever the
    mesh."""
    state = model.state_dict()
    for name, dim in getattr(model, "head_split", {}).items():
        state[name] = gather_split(state[name], dim, model.mesh)
    return state


def _split_slots(state: dict, optimizer, model):
    """(slots, parameter, split dim) of each head shard that holds
    optimizer slots in ``state`` (an optimizer's state dict).  The slots
    are a copy put in ``state``'s place: ``optimizer.state_dict()`` hands
    out the live optimizer's own dicts."""
    split = getattr(model, "head_split", {})
    dims = {id(p): split[n] for n, p in model.named_parameters()
            if n in split}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for index, p in enumerate(params):
        if id(p) in dims and state["state"].get(index):
            slots = state["state"][index] = dict(state["state"][index])
            yield slots, p, dims[id(p)]


def full_optimizer_state(optimizer, model) -> dict:
    """``optimizer.state_dict()`` with the slots of the head's shards
    (momentum, Adam's moments) joined into full tensors, as
    :func:`full_model_state` joins the parameters."""
    state = optimizer.state_dict()
    for slots, p, dim in _split_slots(state, optimizer, model):
        for k, v in slots.items():
            if torch.is_tensor(v) and v.shape == p.shape:
                slots[k] = gather_split(v, dim, model.mesh)
    return state


def cut_optimizer_state(state: dict, optimizer, model) -> dict:
    """A full optimizer state (:func:`full_optimizer_state`) cut to this
    model rank's shards."""
    for slots, p, dim in _split_slots(state, optimizer, model):
        for k, v in slots.items():
            if torch.is_tensor(v) and v.dim() == p.dim() \
                    and v.shape[dim] == p.shape[dim] * model.mesh.model:
                slots[k] = cut_split(v, dim, model.mesh)
    return state


def average_running_stats_(model) -> None:
    """Average every BatchNorm's running statistics over the data group
    (per-replica BN: the running update is linear in the batch statistics,
    so the mean of the ranks' updates is the update by the mean of their
    statistics)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or not mesh.distributed or mesh.data == 1:
        return
    with torch.no_grad():
        all_reduce_mean_(running_stats(model), mesh.data_group, mesh.data)


def running_stats(model) -> List[torch.Tensor]:
    """Every BatchNorm's running mean and variance, in module order."""
    return [b for name, b in model.named_buffers()
            if name.endswith((".mean", ".var"))]
