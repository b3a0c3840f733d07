"""Data parallelism over ``torch.distributed`` (counterpart of
``confignet_tpu/parallel/mesh.py``).

The JAX package's mesh is one process driving every device of a slice: a
train step is one jitted function whose batch is sharded over the ``data``
axis and whose parameters are replicated, and XLA inserts the gradient
reductions.  The port's counterpart is a process group, PyTorch's own idiom:
one process per card (launched by ``torchrun``), each holding a replica of
the parameters and its own contiguous rows of every global batch.  A step
then computes what the single-device step computes at the global batch,
provided each loss is a mean over equal shards: the trainers all-reduce each
player's gradient (:func:`all_reduce_mean`) between the backward and the
optimizer step, and a statistic over the batch inside a loss goes through
:func:`all_reduce_sum`, whose backward sums the statistic's gradient over
the ranks.  ``DistributedDataParallel`` is not used: the trainers take every
gradient with ``torch.autograd.grad`` (the R1 penalty differentiates
twice), which DDP's backward hooks do not see.

Without an initialised process group :func:`create_mesh` gives a mesh of
size 1 whose reductions are the identity and launch no collective, so a
plain single-process run takes the same step as ``mesh=None``.  A group of
size 1 still launches its collectives.

The JAX package's ``batch_sharding`` and ``replicated_sharding`` build
``NamedSharding`` objects; a process group has no counterpart of them.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from confignet_tpu_torch.core.device import resolve_device

# the collectives this module launches, the keys of Mesh.launches
COLLECTIVES = ("all_reduce_mean", "all_reduce_sum", "all_gather_rows", "broadcast")


class Mesh:
    """A process group (``None``: this process alone, size 1), its size,
    this process's rank in it and the device the rank computes on.
    ``launches`` counts, by function, the collectives launched over it."""

    def __init__(self, group, size: int, rank: int, device: Union[str, torch.device]):
        self.group = group
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.launches: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)


def create_mesh(group=None, device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """A data-parallel mesh over ``group`` (default: every process of the
    initialised ``torch.distributed`` world) on ``device`` (default:
    ``cuda:LOCAL_RANK``); without an initialised process group, a mesh of
    size 1 on ``device`` (default ``cuda``)."""
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group needs an initialised torch.distributed")
        return Mesh(None, 1, 0, resolve_device(device))
    if group is None:
        group = dist.group.WORLD
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group), resolve_device(device))


def process_slice(global_rows: int, mesh: Optional[Mesh] = None) -> slice:
    """This rank's contiguous row range of a ``global_rows``-long batch axis.

    Every rank draws the same global index arrays (identically seeded
    generators stay in lockstep) and gathers only its own rows, so no rank
    materialises the global batch."""
    n = 1 if mesh is None else mesh.size
    if n == 1:
        return slice(None)
    if global_rows % n != 0:
        raise ValueError(f"global batch rows ({global_rows}) must divide evenly over {n} processes")
    per = global_rows // n
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, value) for value in tree)
    return fn(tree)


def _tree_leaves(tree) -> List[Any]:
    leaves: List[Any] = []
    _tree_map(leaves.append, tree)
    return leaves


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A tensor on ``device``; a numpy array is copied (never shared, so a
    broadcast into the result leaves the caller's array as it was)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def shard_batch(mesh: Mesh, batch: Any, batch_axis: int = 0, *, local_rows: bool = False) -> Any:
    """Every array leaf of ``batch`` (dicts, lists and tuples of numpy arrays
    or tensors) as a tensor on ``mesh.device`` holding this rank's rows of
    its ``batch_axis``.

    ``local_rows=False`` (default): each leaf is the full global batch,
    identical on every rank (the serving and fine-tune paths), and this rank
    takes its :func:`process_slice` rows.  ``local_rows=True``: each leaf
    already holds only this rank's rows (the trainers' host batches)."""
    def put(x):
        if not local_rows:
            x = x[(slice(None),) * batch_axis + (process_slice(x.shape[batch_axis], mesh),)]
        return _to_device(x, mesh.device)

    return _tree_map(put, batch)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for tensor in tensors:
        groups.setdefault(tensor.dtype, []).append(tensor)
    return list(groups.values())


@torch.no_grad()
def _coalesced(mesh: Mesh, tensors: Sequence[torch.Tensor], name: str, collective) -> None:
    """``collective(flat)`` on one flat buffer per dtype holding every tensor,
    then each tensor overwritten, in place, from the buffer."""
    for same in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        collective(flat)
        mesh.launches[name] += 1
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicate(mesh: Mesh, module_or_tensors: Any) -> Any:
    """Rank 0's values on every rank: a module's parameters and buffers, or
    every leaf of a tree of tensors or numpy arrays, moved to ``mesh.device``
    and broadcast from rank 0 (one buffer per dtype).  A module is updated in
    place and returned; a tree comes back as tensors."""
    if isinstance(module_or_tensors, torch.nn.Module):
        module = module_or_tensors.to(mesh.device)
        tensors = list(module.parameters()) + list(module.buffers())
        result = module
    else:
        result = _tree_map(lambda x: _to_device(x, mesh.device), module_or_tensors)
        tensors = _tree_leaves(result)
    if mesh.group is not None and tensors:
        source = dist.get_global_rank(mesh.group, 0)
        _coalesced(mesh, tensors, "broadcast",
                   lambda flat: dist.broadcast(flat, src=source, group=mesh.group))
    return result


def all_reduce_mean(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor replaced, in place, by its mean over the ranks: one
    coalesced all-reduce (sum, then a division by ``mesh.size``) per dtype.
    Returns the tensors."""
    tensors = list(tensors)
    if mesh is None or mesh.group is None or not tensors:
        return tensors

    def mean(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)

    _coalesced(mesh, tensors, "all_reduce_mean", mean)
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward sums the incoming gradient over
    the ranks too, since every rank's loss depends on every rank's input."""

    @staticmethod
    def forward(ctx, tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        out = tensor.contiguous().clone()
        dist.all_reduce(out, group=mesh.group)
        mesh.launches["all_reduce_sum"] += 1
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.group)
        ctx.mesh.launches["all_reduce_sum"] += 1
        return grad, None


def all_reduce_sum(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks, differentiable (a batch
    statistic inside a loss); ``tensor`` itself without a process group."""
    if mesh is None or mesh.group is None:
        return tensor
    return _AllReduceSum.apply(tensor, mesh)


def all_gather_rows(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``tensor``, concatenated in rank order along the
    first axis (the global batch, on every rank)."""
    if mesh is None or mesh.group is None:
        return tensor
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(mesh.size)]
    dist.all_gather(parts, tensor, group=mesh.group)
    mesh.launches["all_gather_rows"] += 1
    return torch.cat(parts)


def maybe_initialize_distributed(device: Optional[Union[str, torch.device]] = None) -> None:
    """Initialise ``torch.distributed`` from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) for ranks that compute on ``device``: gloo for the CPU,
    else NCCL with this process on ``cuda:LOCAL_RANK`` (the default device,
    which raises without a GPU, as :func:`resolve_device` does).  The
    backend follows the device, not the machine: CPU ranks beside a card
    still run over gloo.  Does nothing without that environment or when a
    process group is already initialised."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if resolve_device(device).type == "cpu":
        dist.init_process_group("gloo")
        return
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl")
