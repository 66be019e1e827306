"""The collectives of the mesh: what GSPMD and ``multihost_utils`` do
implicitly for the JAX package, written out over ``torch.distributed``
process groups.

The data axis (each function takes the ``group`` of its ranks; None is the
default group, the data axis of a mesh that spans every rank and has no
``model`` axis, as ``Mesh.data_group`` is then):

* ``gather_rows``: every rank's rows, in rank order, with the transpose
  JAX's ``all_gather`` has as its gradient (each rank's loss scores every
  rank's rows, so a row's gradient is the sum over every rank's loss);
* ``all_reduce_mean_``: gradients averaged in place over flat fp32 buckets;
* ``gather_host``: every rank's rows on the host (``process_allgather``);
* ``any_rank``: a flag raised on any rank (the agreed preemption), over
  host memory, so that agreeing on it every batch syncs no device.

The model axis (tensor parallel; ``ModelAxis`` names its group), as
autograd functions, Megatron's pair and the statistics of a norm:

* ``copy_to_model``: identity forward, all-reduce backward, at the input
  of every region whose weights are split by output features (and on a
  replicated parameter that such a region reads in part);
* ``reduce_from_model``: all-reduce forward, identity backward, at every
  output of weights split by input features (and of the vocabulary
  split's masked lookup, where one rank holds each row);
* ``all_reduce_model``: all-reduce both ways, for a sum that every rank
  reads (a LayerNorm's statistics over split channels).

The model axis sums in fp32 whatever the activations' dtype. NCCL serves
the card and gloo the CPU; gloo also takes CUDA tensors for the
collectives used here (``all_reduce``, ``all_gather_into_tensor``), which
is how two ranks share one card, where NCCL refuses them. Without a
process group each function is the identity of one rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# flat fp32 buckets of the gradient all-reduce: 64 MiB, so the retrieval
# model's 354.8M trainable values (1.42 GB) take 22 collectives
BUCKET_BYTES = 64 << 20


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group`` (the default group: its global
    rank)."""
    return dist.get_rank(group) if initialized() else 0


def require(axis_name: str) -> None:
    """Raise unless a process group spans the ``axis_name`` axis."""
    if not initialized():
        raise RuntimeError(
            f"axis_name={axis_name!r} needs the {axis_name!r} process "
            "group, and no torch.distributed process group is initialised: "
            "launch with torchrun (train.py calls "
            "parallel.mesh.maybe_initialize_distributed), or pass "
            "axis_name=None in one process")


def _all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM,
                 group=None) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """[N·rows, ...]: every rank's ``t`` (same shape on every rank)
    stacked along the first axis in rank order."""
    out = torch.empty((world_size(group) * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.detach().contiguous(), group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.group = x.shape[0], group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        # the gradient of every rank's loss with respect to the gathered
        # rows, summed over ranks; this rank's rows of the sum
        total = _all_reduce_(grad.contiguous().clone(), group=ctx.group)
        r = rank(ctx.group) * ctx.rows
        return total[r:r + ctx.rows], None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[N·B, ...] from every rank's [B, ...], differentiable: the backward
    all-reduces the full gradient and keeps this rank's slice (JAX's
    ``all_gather`` transpose). Collective: every rank must call it, in the
    same order, forward and backward."""
    if not initialized():
        return x
    return _GatherRows.apply(x, group)


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    out, size = [[]], 0
    for t in tensors:
        if out[-1] and size + 4 * t.numel() > BUCKET_BYTES:
            out.append([])
            size = 0
        out[-1].append(t)
        size += 4 * t.numel()
    return [b for b in out if b]


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks, in place: the
    tensors are packed into flat fp32 buckets of about ``BUCKET_BYTES``,
    one all-reduce each. Every rank ends with the same bits."""
    if not initialized():
        return
    n = world_size(group)
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        _all_reduce_(flat, group=group).div_(n)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def mean_over_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """A new tensor: ``t`` averaged over the ranks (fp32)."""
    out = t.detach().float().clone()
    if initialized():
        _all_reduce_(out, group=group).div_(world_size(group))
    return out


@torch.no_grad()
def sum_over_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """A new tensor: ``t`` summed over the ranks."""
    out = t.detach().clone()
    if initialized():
        _all_reduce_(out, group=group)
    return out


@torch.no_grad()
def gather_host(x: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's ``x`` (the same shape on every rank) on the host,
    stacked along the first axis in rank order: the counterpart of the JAX
    loop's ``_to_host`` / ``process_allgather(tiled=True)``."""
    if not initialized():
        return x.detach().cpu().numpy()
    return all_gather(x, group).cpu().numpy()


# (the default group, its gloo twin): the group ``any_rank`` uses beside
# an NCCL default group; the strong reference keeps the default group's
# identity from being reused by a later group
_HOST_GROUP = (None, None)


def _host_group():
    """A gloo group over every rank, for flags in host memory: the default
    group when it is gloo, else a twin made on first use (a collective,
    which every rank reaches at the same call of ``any_rank``)."""
    global _HOST_GROUP
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if _HOST_GROUP[0] is not world:
        _HOST_GROUP = (world, dist.new_group(backend="gloo"))
    return _HOST_GROUP[1]


def any_rank(flag: bool, host_group=None) -> bool:
    """True on every rank when ``flag`` is True on any (an all-reduce MAX
    of a host tensor over gloo: no device sync, a loopback round trip
    between the ranks of one host); the local flag without a process
    group. ``host_group``: a gloo group of the ranks that agree (None:
    every rank)."""
    if not initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=host_group if host_group is not None
                    else _host_group())
    return bool(t.item())


def barrier(group=None) -> None:
    if initialized():
        dist.barrier(group=group)


# store barriers passed in this process: each call waits on a key of its own
_STORE_BARRIERS = [0]


def store_barrier() -> None:
    """Wait until every rank of the default group reaches this call,
    through the group's store and none of its connections. A rank that
    leaves the group early (outside a shrunk mesh) closes its sockets, and
    gloo's ``init_process_group`` fails on a slower rank that is still
    connecting to it ("Connection closed by peer"); no rank passes this
    before every rank has finished ``init_process_group``."""
    if not initialized():
        return
    _STORE_BARRIERS[0] += 1
    key = f"ste_store_barrier/{_STORE_BARRIERS[0]}"
    store = dist.distributed_c10d._get_default_store()
    if store.add(key, 1) == dist.get_world_size():
        store.set(key + "/all", "1")
    store.wait([key + "/all"])


# ---- the model axis (tensor parallel) ---------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """The ``model`` axis as a tensor-parallel layer sees it: ``size``
    ranks, this rank at ``index``, ``group`` their process group (None:
    the default group). A model holds it by reference: a deep copy of the
    model shares it."""
    size: int
    index: int
    group: Optional[object] = None

    def part(self, n: int) -> int:
        """This rank's share of ``n`` features or heads; raises unless the
        axis divides ``n``."""
        if n % self.size:
            raise ValueError(f"{n} does not split over the {self.size} "
                             "ranks of the model axis")
        return n // self.size

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous part of ``t`` along ``dim``."""
        per = self.part(t.shape[dim])
        return t.narrow(dim, self.index * per, per)

    def __deepcopy__(self, memo):
        return self


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor of ``t``'s dtype: ``t`` summed over ``group`` in
    fp32."""
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    out.copy_(t)
    return _all_reduce_(out, group=group).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]
                  ) -> torch.Tensor:
    """``x`` (the same on every rank of the model axis) as the input of a
    split region: its gradient, which each rank holds in part, is summed
    over the axis. Identity without an axis."""
    if axis is None:
        return x
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: Optional[ModelAxis]
                      ) -> torch.Tensor:
    """The sum over the model axis of each rank's partial ``x``; every
    rank receives the whole gradient. Identity without an axis."""
    if axis is None:
        return x
    return _ReduceFromModel.apply(x, axis.group)


def all_reduce_model(x: torch.Tensor, axis: Optional[ModelAxis]
                     ) -> torch.Tensor:
    """The sum over the model axis of each rank's ``x``, read by every
    rank: its gradient is summed over the axis too."""
    if axis is None:
        return x
    return _AllReduceModel.apply(x, axis.group)
