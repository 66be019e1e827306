"""The device mesh over the ranks of a process group, and the sharding
rule of its ``model`` axis.

Port of ``speech_transcript_embeddings_tpu/parallel/mesh.py``. JAX lays one
global array over every chip of a ``Mesh``; the port runs one process per
device (``torchrun``), and a rank's place on the (data × model) mesh
follows JAX's device order, ``np.reshape(devices, (data, model))``:
``rank = data_index·model + model_index``.

* ``data``: each rank of a data row holds its own rows of every batch.
  ``data.batch_size`` stays the GLOBAL batch: every rank runs the same
  seeded pipeline (the same shuffle and buckets, so the batches agree with
  no coordination) and keeps rows ``[d·B/D, (d+1)·B/D)`` of each assembled
  batch for its ``data_index`` d, as JAX's multi-host loop does
  (``host_batch_slice``). The decode of the whole stream is therefore
  repeated on every rank, as in JAX.
* ``model`` (tensor parallel): the ranks of one data row hold one shard
  each of every parameter that ``shard_dim`` names, and of its optimizer
  state (JAX's ``_RULES``, ``flat_param_shardings`` and
  ``opt_state_shardings``), and compute the same step through the
  collectives of ``collectives.py``. ``shard_state`` / ``gather_state``
  carry a whole, one-process state to a rank and back: checkpoints stay in
  the one-process layout.

``make_mesh`` follows JAX's arithmetic: ``mesh.num_data`` below
``world / num_model`` takes the first ``num_data·num_model`` ranks, and a
global batch the data axis does not divide shrinks it to the gcd. The
ranks left outside do not train (``Mesh.active``).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from speech_transcript_embeddings_torch.parallel import collectives
from speech_transcript_embeddings_torch.parallel.collectives import ModelAxis

logger = logging.getLogger(__name__)

# what a launcher (torchrun) sets in every process it starts
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")



def _group():
    """A process-group field: not compared, not shown."""
    return dataclasses.field(default=None, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` × ``model`` ranks of the process group (1 × 1 without
    one), and this process's place: its global ``rank`` and ``local_rank``
    (the card it drives on its host). The process groups of its axes (None:
    the default group) are made by ``make_mesh`` on every rank:
    ``data_group`` (this rank's data axis: the ranks of its model index),
    ``model_group`` (its data row), ``active_group`` (the mesh's ranks) and
    ``host_group`` (gloo, over the mesh's ranks, for flags in host
    memory). ``note``: JAX's warning when ``make_mesh`` shrank the data
    axis, for the run's log."""
    data: int = 1
    model: int = 1
    rank: int = 0
    local_rank: int = 0
    data_group: Optional[object] = _group()
    model_group: Optional[object] = _group()
    active_group: Optional[object] = _group()
    host_group: Optional[object] = _group()
    note: str = dataclasses.field(default="", compare=False, repr=False)

    @property
    def active(self) -> bool:
        """Whether this rank is on the mesh (a shrunk mesh leaves ranks
        out)."""
        return self.rank < self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def model_axis(self) -> Optional[ModelAxis]:
        """The model axis the tensor-parallel layers take; None without
        tensor parallel."""
        if self.model == 1:
            return None
        return ModelAxis(self.model, self.model_index, self.model_group)


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
    process group, with JAX's ``make_mesh`` arithmetic: ``mesh.num_model``
    must divide the ranks; ``mesh.num_data = -1`` takes the rest, a smaller
    value the first ``num_data·num_model`` ranks, and a larger one raises.
    A global batch the data axis does not divide shrinks it to
    gcd(batch, data); JAX's warning is the mesh's ``note``. Collective under
    a process group: every rank makes the axes' groups, in one order, and
    where ranks are left outside, waits for every rank at the store."""
    world = collectives.world_size()
    rank = collectives.rank()
    model = max(cfg.mesh.num_model, 1)
    if world % model:
        raise ValueError(f"{world} devices not divisible by model={model}")
    data = cfg.mesh.num_data if cfg.mesh.num_data > 0 else world // model
    if data * model > world:
        raise ValueError(
            f"mesh.num_data={data} but the process group has {world} "
            f"rank(s): a mesh of data={data} × model={model} needs "
            f"{data * model}; launch them with torchrun "
            f"--nproc_per_node={data * model}, or leave mesh.num_data=-1")
    note = ""
    if cfg.data.batch_size % data:
        g = math.gcd(cfg.data.batch_size, data)
        note = (f"batch_size {cfg.data.batch_size} not divisible by the "
                f"{data}-way data axis; shrinking the mesh to data={g}")
        data = g
    if not collectives.initialized():
        return Mesh(data=data, model=model, note=note)
    local = int(os.environ.get("LOCAL_RANK", rank))
    groups = _axis_groups(world, rank, data, model)
    if data * model < world:
        # the ranks left outside return at once: not before every rank
        # has joined the process group
        collectives.store_barrier()
    return Mesh(data=data, model=model, rank=rank, local_rank=local,
                note=note, **groups)


def _axis_groups(world: int, rank: int, data: int, model: int) -> dict:
    """The process groups of a (data × model) mesh over ranks
    ``[0, data·model)`` of ``world``, as this rank sees them (None: the
    default group). ``dist.new_group`` is entered by every rank, members
    or not, in the same order."""
    def mine(rank_sets, **kw):
        """The group of the set holding this rank (each set made)."""
        made = [(dist.new_group(list(r), **kw), r) for r in rank_sets]
        return next((g for g, r in made if rank in r), None)

    n = data * model
    active = None if n == world else mine([range(n)])
    out = dict(active_group=active, data_group=active, model_group=None,
               host_group=active)
    if model > 1:
        out["data_group"] = mine([range(m, n, model) for m in range(model)])
        out["model_group"] = mine([range(d * model, (d + 1) * model)
                                   for d in range(data)])
    if dist.get_backend() != "gloo" and n < world:
        out["host_group"] = mine([range(n)], backend="gloo")
    return out


def host_batch_slice(global_batch_size: int, mesh: Mesh) -> Tuple[int, int]:
    """(this rank's row offset, rows per data index) of the GLOBAL
    batch."""
    n, r = mesh.data, mesh.data_index
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n} processes")
    per = global_batch_size // n
    return r * per, per


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's rows of every field of an assembled host batch (numpy
    views, no copy); the batch itself on a data axis of one rank."""
    if mesh.data == 1:
        return batch
    off, per = host_batch_slice(len(batch["waveform"]), mesh)
    return {k: v[off:off + per] for k, v in batch.items()}


# ---- the model axis: which parameters are split, and how --------------------

# JAX's ``_RULES`` over the port's parameter names (dotted module paths) →
# the dimension split over the model axis, in the port's layouts: Dense
# ``weight [out, in]`` (JAX ``P(None, m)`` on ``kernel [in, out]`` is dim
# 0, ``P(m, None)`` dim 1), biases ``[out]``, the depthwise kernel
# ``[H, 1, K]`` (JAX ``[K, 1, H]``), Embed ``[vocab, D]``. Everything else is
# replicated.
_RULES: List[Tuple[str, int]] = [
    # attention projections: split heads (output dim) / recombine on out
    (r".*attention\.(query|key|value)\.weight$", 0),
    (r".*attention\.(query|key|value)\.bias$", 0),
    (r".*attention\.out\.weight$", 1),
    (r".*(attn_q|attn_k|attn_v)\.weight$", 0),
    (r".*attn_out\.weight$", 1),
    # FFN / projection MLPs: expand → split outputs, contract → inputs
    (r".*(intermediate|dense_in)\.weight$", 0),
    (r".*(intermediate|dense_in)\.bias$", 0),
    (r".*(output|dense_out)\.weight$", 1),
    # conformer conv module
    (r".*conv\.pointwise1\.weight$", 0),
    (r".*conv\.pointwise2\.weight$", 1),
    (r".*depthwise_kernel$", 0),
    # the big embedding table: split the vocabulary, padded to a multiple
    (r".*word_embeddings\.weight$", 0),
]
# the GLU projection: its rows are [a | g], and a rank holds [a_r | g_r]
_GLU = r".*conv\.pointwise1\.weight$"
# tables whose split dimension is padded (with zero rows) to a multiple
_PADDED = r".*word_embeddings\.weight$"


def shard_dim(name: str) -> Optional[int]:
    """The dimension of the port parameter ``name`` split over the model
    axis, or None (replicated)."""
    for pattern, dim in _RULES:
        if re.match(pattern, name):
            return dim
    return None


def shard_tensor(name: str, full: torch.Tensor, size: int, index: int
                 ) -> torch.Tensor:
    """Shard ``index`` of ``size`` of the whole parameter (or optimizer
    leaf) ``name``: a view where it can be; a padded table's last shard is
    a copy with zero rows after the table's."""
    dim = shard_dim(name)
    if dim is None or size == 1:
        return full
    if re.match(_GLU, name):
        return torch.cat([_part(half, dim, size, index, name)
                          for half in full.chunk(2, dim)], dim)
    return _part(full, dim, size, index, name,
                 padded=bool(re.match(_PADDED, name)))


def _part(full, dim, size, index, name, padded=False):
    n = full.shape[dim]
    if n % size and not padded:
        raise ValueError(f"{name}: {n} does not split over {size} ranks")
    per = -(-n // size)
    lo, hi = min(index * per, n), min((index + 1) * per, n)
    part = full.narrow(dim, lo, hi - lo)
    if hi - lo == per:
        return part
    pad = list(full.shape)
    pad[dim] = per - (hi - lo)
    return torch.cat([part, part.new_zeros(pad)], dim)


def merge_shards(name: str, shards: Sequence[torch.Tensor],
                 full_shape: Sequence[int]) -> torch.Tensor:
    """The whole parameter ``name`` of ``full_shape`` from its shards in
    model-index order (the inverse of ``shard_tensor``)."""
    dim = shard_dim(name)
    if dim is None:
        return shards[0]
    if re.match(_GLU, name):
        halves = [s.chunk(2, dim) for s in shards]
        return torch.cat([torch.cat([h[i] for h in halves], dim)
                          for i in range(2)], dim)
    whole = torch.cat(list(shards), dim)
    if whole.shape[dim] == full_shape[dim]:
        return whole
    return whole.narrow(dim, 0, full_shape[dim]).clone()   # padding off


def shard_state(full_state: Dict[str, torch.Tensor], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's shards of a whole, one-process state (parameters, or
    one optimizer leaf per parameter name)."""
    return {k: shard_tensor(k, v, mesh.model, mesh.model_index)
            for k, v in full_state.items()}


@torch.no_grad()
def gather_state(shards: Dict[str, torch.Tensor], mesh: Mesh,
                 full_shapes: Dict[str, Sequence[int]]
                 ) -> Dict[str, torch.Tensor]:
    """The whole, one-process state on the host from this rank's shards
    (the inverse of ``shard_state``), one leaf at a time: each split leaf
    is gathered over the model axis on its device, then copied to the
    host, so the device holds one whole leaf at most. Collective over the
    model axis: every rank of the data row calls it, with the same
    names."""
    out = {}
    for k, v in shards.items():
        if mesh.model == 1 or shard_dim(k) is None:
            out[k] = v.detach().cpu()
            continue
        whole = collectives.all_gather(v.detach().contiguous()[None],
                                        mesh.model_group).cpu()
        out[k] = merge_shards(k, whole.unbind(0), full_shapes[k])
    return out
