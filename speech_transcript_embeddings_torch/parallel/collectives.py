"""The collectives of the data axis: what GSPMD and ``multihost_utils`` do
implicitly for the JAX package, written out over the default
``torch.distributed`` process group.

* ``gather_rows``: every rank's rows, in rank order, with the transpose
  JAX's ``all_gather`` has as its gradient (each rank's loss scores every
  rank's rows, so a row's gradient is the sum over every rank's loss);
* ``all_reduce_mean_``: gradients averaged in place over flat fp32 buckets;
* ``gather_host``: every rank's rows on the host (``process_allgather``);
* ``any_rank``: a flag raised on any rank (the agreed preemption), over
  host memory, so that agreeing on it every batch syncs no device.

NCCL serves the card and gloo the CPU; gloo also takes CUDA tensors for
both collectives used here (``all_reduce``, ``all_gather_into_tensor``),
which is how two ranks share one card, where NCCL refuses them. Without a
process group each function is the identity of one rank.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

# flat fp32 buckets of the gradient all-reduce: 64 MiB, so the retrieval
# model's 354.8M trainable values (1.42 GB) take 22 collectives
BUCKET_BYTES = 64 << 20


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def require(axis_name: str) -> None:
    """Raise unless a process group spans the ``axis_name`` axis."""
    if not initialized():
        raise RuntimeError(
            f"axis_name={axis_name!r} needs the {axis_name!r} process "
            "group, and no torch.distributed process group is initialised: "
            "launch with torchrun (train.py calls "
            "parallel.mesh.maybe_initialize_distributed), or pass "
            "axis_name=None in one process")


def _all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op)
    return t


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """[N·rows, ...]: every rank's ``t`` (same shape on every rank)
    stacked along the first axis in rank order."""
    out = torch.empty((world_size() * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.detach().contiguous())
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        # the gradient of every rank's loss with respect to the gathered
        # rows, summed over ranks; this rank's rows of the sum
        total = _all_reduce_(grad.contiguous().clone())
        r = rank() * ctx.rows
        return total[r:r + ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[N·B, ...] from every rank's [B, ...], differentiable: the backward
    all-reduces the full gradient and keeps this rank's slice (JAX's
    ``all_gather`` transpose). Collective: every rank must call it, in the
    same order, forward and backward."""
    if not initialized():
        return x
    return _GatherRows.apply(x)


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
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: the
    tensors are packed into flat fp32 buckets of about ``BUCKET_BYTES``,
    one all-reduce each. Every rank ends with the same bits."""
    if not initialized():
        return
    n = world_size()
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        _all_reduce_(flat).div_(n)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``t`` averaged over the ranks (fp32)."""
    out = t.detach().float().clone()
    if initialized():
        _all_reduce_(out).div_(world_size())
    return out


@torch.no_grad()
def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``t`` summed over the ranks."""
    out = t.detach().clone()
    if initialized():
        _all_reduce_(out)
    return out


@torch.no_grad()
def gather_host(x: torch.Tensor) -> np.ndarray:
    """Every rank's ``x`` (the same shape on every rank) on the host,
    stacked along the first axis in rank order: the counterpart of the JAX
    loop's ``_to_host`` / ``process_allgather(tiled=True)``."""
    if not initialized():
        return x.detach().cpu().numpy()
    return _all_gather(x).cpu().numpy()


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


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any (an all-reduce MAX
    of a host tensor over gloo: no device sync, a loopback round trip
    between the ranks of one host); the local flag without a process
    group."""
    if not initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group())
    return bool(t.item())


def barrier() -> None:
    if initialized():
        dist.barrier()
