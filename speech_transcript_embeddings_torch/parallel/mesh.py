"""The data axis of the device mesh, over the ranks of a process group.

Port of the ``data`` axis of ``speech_transcript_embeddings_tpu/parallel/
mesh.py``. JAX lays one global array over every chip of a ``Mesh``; the
port runs one process per device (``torchrun``), each holding a full
replica of the model and its own rows of every batch.
``data.batch_size`` stays the GLOBAL batch: every rank runs the same
seeded pipeline (the same shuffle and buckets, so the batches agree with no
coordination) and keeps rows ``[r·B/N, (r+1)·B/N)`` of each assembled
batch, as JAX's multi-host loop does (``host_batch_slice``). The decode of
the whole stream is therefore repeated on every rank, as in JAX.

The ``model`` axis (tensor parallel) is not ported: ``make_mesh`` refuses
``mesh.num_model > 1``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from speech_transcript_embeddings_torch.parallel import collectives

logger = logging.getLogger(__name__)

# what a launcher (torchrun) sets in every process it starts
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` ranks of the process group (1 without one), no ``model``
    axis, and this process's place: its ``rank`` and ``local_rank`` (the
    card it drives on its host)."""
    data: int = 1
    model: int = 1
    rank: int = 0
    local_rank: int = 0


def maybe_initialize_distributed(flag: bool, device="cuda") -> int:
    """Join the process group the launcher describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for a CUDA
    ``device``, gloo for the CPU (the card a rank drives is
    ``make_mesh``'s ``local_rank``, which the loop selects before the
    first collective). No-op when ``flag`` is False or a group exists; a
    logged no-op without a launcher's environment (one process), as JAX's
    ``jax.distributed.initialize`` skip is. A launcher environment with a
    variable missing raises: that run does not fall back to one process.
    → the number of processes."""
    if flag and not collectives.initialized():
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if len(missing) == len(LAUNCHER_ENV):
            logger.info("torch.distributed not initialised: no launcher "
                        "environment (%s unset); one process",
                        ", ".join(missing))
        elif missing:
            raise RuntimeError(
                f"an incomplete launcher environment: {', '.join(missing)} "
                "unset; launch with torchrun")
        else:
            backend = "nccl" if torch.device(device).type == "cuda" \
                else "gloo"
            dist.init_process_group(backend, init_method="env://")
    return collectives.world_size()


def make_mesh(cfg) -> Mesh:
    """The mesh of ``cfg`` (an ``ExperimentConfig``) over the current
    process group. ``mesh.num_data = -1`` takes every rank; any other value
    must equal the number of ranks. JAX shrinks its mesh to
    gcd(batch, devices) when the global batch does not divide; ranks cannot
    be shrunk away, so an indivisible batch raises."""
    world = collectives.world_size()
    rank = collectives.rank()
    if cfg.mesh.num_model > 1:
        raise NotImplementedError(
            f"mesh.num_model={cfg.mesh.num_model}: tensor parallel training "
            "(the model axis) is not ported yet (ROADMAP.md, Queue 1 item "
            "5); use mesh.num_model=1")
    data = world if cfg.mesh.num_data == -1 else cfg.mesh.num_data
    if data != world:
        raise ValueError(
            f"mesh.num_data={data} but the process group has {world} "
            f"rank(s): launch {data} processes with torchrun "
            f"--nproc_per_node={data}, or leave mesh.num_data=-1")
    if cfg.data.batch_size % data:
        raise ValueError(
            f"data.batch_size={cfg.data.batch_size} (the global batch) is "
            f"not divisible by the {data} ranks of the data axis; ranks "
            "cannot be dropped as JAX shrinks its mesh to the gcd: choose a "
            "batch size that divides")
    local = int(os.environ.get("LOCAL_RANK", rank)) \
        if collectives.initialized() else 0
    return Mesh(data=data, model=1, rank=rank, local_rank=local)


def host_batch_slice(global_batch_size: int, mesh: Mesh) -> Tuple[int, int]:
    """(this rank's row offset, rows per rank) of the GLOBAL batch."""
    n, r = mesh.data, mesh.rank
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n} processes")
    per = global_batch_size // n
    return r * per, per


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's rows of every field of an assembled host batch (numpy
    views, no copy); the batch itself on a mesh of one rank."""
    if mesh.data == 1:
        return batch
    off, per = host_batch_slice(len(batch["waveform"]), mesh)
    return {k: v[off:off + per] for k, v in batch.items()}
