"""Port checkpoints: ``metadata.json`` (the JAX schema) + ``model.pt``
(+ ``optimizer.pt``).

``metadata.json`` carries ``format_version``, ``kind = "torch_params"`` and
the full ``ExperimentConfig`` as JSON, like the JAX package's checkpoints
(``training/checkpoints.py``). A training checkpoint (``save_checkpoint``:
``latest``, ``best_model_loss``, ``best_model_gap``, ``checkpoint_epoch_N``,
``final_model``) adds JAX's ``epoch``, ``params_only`` and ``metrics``; a
params checkpoint (``save_params_checkpoint``: a model alone, e.g. seeded
serving weights) adds ``info``. ``model.pt`` is ``torch.save`` of the
model's ``state_dict`` in the dtypes it is stored in (a trained model: fp32
trainable parameters, the frozen split in its frozen dtype); unless the
checkpoint is params-only, ``optimizer.pt`` holds the optimizer's
``state_dict`` and the micro-step count, which ``restore_checkpoint`` needs
to resume. Loading casts every tensor to the storage of the model it goes
into: ``load_checkpoint`` to the serving storage (Dense and Embed weights in
the compute dtype), ``load_into`` to a given model's. Every checkpoint is
written into ``path.tmp`` and renamed over ``path``, so a crash mid-save
never destroys the previous one. Foreign weights become a port checkpoint
through ``convert_checkpoint.py`` (HF encoders, a reference ``*.pt``); the
JAX package's orbax checkpoints are not read here: bring one across with
``bridge.py`` in a process that has JAX. Under data parallel training every
rank holds the same weights and optimizer state: ``save_checkpoint`` writes
on rank 0 while the other ranks wait at a barrier, and every rank restores
onto its own device. Under tensor parallel a checkpoint stays in the
one-process layout: the ranks of data row 0 gather each split leaf (the
parameters, μ, ν and the accumulator) one at a time onto the host before
rank 0 writes, and a restore (``restore_checkpoint``, ``load_into`` with a
mesh) reads the whole state on the host and keeps each rank's shard. So a
tensor-parallel ``final_model`` serves as it is, and a ``latest`` resumes
at another ``mesh.num_model``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import torch

from speech_transcript_embeddings_torch.config import ExperimentConfig
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel,
)
from speech_transcript_embeddings_torch.parallel import collectives
from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib

FORMAT_VERSION = 1
KIND = "torch_params"


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "metadata.json"))


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, "metadata.json")) as f:
        return json.load(f)


def _atomic_replace(tmp: str, path: str) -> None:
    old = path + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _write(path: str, meta: dict, files: dict) -> int:
    """Write ``files`` (name → object for ``torch.save``) and the metadata
    into ``path.tmp``, rename it over ``path``; → bytes written."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for name, obj in files.items():
        torch.save(obj, os.path.join(tmp, name))
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    size = sum(os.path.getsize(os.path.join(tmp, n)) for n in os.listdir(tmp))
    _atomic_replace(tmp, path)
    return size


def _whole(shards: dict, mesh: Optional[mesh_lib.Mesh], shapes: dict) -> dict:
    """A state of this rank's shards in the one-process layout on the host
    (a collective of the model axis), or as it is without one."""
    if mesh is None or mesh.model == 1:
        return shards
    return mesh_lib.gather_state(shards, mesh, shapes)


def save_params_checkpoint(path: str, model: DualEncoderModel,
                           cfg: ExperimentConfig,
                           info: Optional[dict] = None) -> int:
    """A model's weights alone (no optimizer state); → bytes written."""
    meta = {"format_version": FORMAT_VERSION, "kind": KIND,
            "info": info or {}, "config": json.loads(cfg.to_json())}
    return _write(path, meta, {"model.pt": model.state_dict()})


def save_checkpoint(path: str, state, cfg: ExperimentConfig, epoch: int,
                    metrics: Optional[dict] = None,
                    params_only: bool = False) -> int:
    """A training checkpoint of ``state`` (a ``TrainState``) after
    ``epoch``; ``params_only`` leaves out ``optimizer.pt`` (the best and
    final checkpoints, which are only evaluated or served). Under a process
    group a collective of ``state.mesh``'s ranks: rank 0 writes (the ranks
    of its data row gather the shards first under tensor parallel), and
    every rank returns once it has. → bytes written (0 on the other
    ranks)."""
    size = 0
    mesh = state.mesh
    if mesh is None or mesh.data_index == 0:
        shapes = state.model.full_shapes()
        files = {"model.pt": _whole(state.model.state_dict(), mesh, shapes)}
        if not params_only:
            opt = state.optimizer.state_dict()
            for key in ("mu", "nu", "acc"):
                if opt[key] is not None:
                    opt[key] = _whole(opt[key], mesh, shapes)
            files["optimizer.pt"] = {"step": state.step, "optimizer": opt}
        if collectives.rank() == 0:
            meta = {"format_version": FORMAT_VERSION, "kind": KIND,
                    "epoch": epoch, "params_only": params_only,
                    "metrics": metrics or {},
                    "config": json.loads(cfg.to_json())}
            size = _write(path, meta, files)
        del files
    collectives.barrier(None if mesh is None else mesh.active_group)
    return size


@torch.no_grad()
def restore_checkpoint(path: str, state):
    """Load a full training checkpoint into ``state`` in place (weights in
    the dtypes ``state.model`` stores them in, the optimizer's state, the
    micro-step count), on the device ``state.model`` lives on → ``state``.
    Under tensor parallel each rank keeps its shards of the one-process
    state, read on the host. A params-only checkpoint has no optimizer
    state to resume from and is refused."""
    if load_metadata(path).get("params_only", True):
        raise ValueError(
            f"{path} is a params-only checkpoint (no optimizer state): load "
            "it with load_into / load_checkpoint, or resume from the "
            "'latest' checkpoint instead")
    mesh = state.mesh
    load_into(path, state.model, mesh)
    split = mesh is not None and mesh.model > 1
    device = next(state.model.parameters()).device
    saved = torch.load(os.path.join(path, "optimizer.pt"),
                       map_location="cpu" if split else device,
                       weights_only=True, mmap=split)
    opt = saved["optimizer"]
    if split:
        for key in ("mu", "nu", "acc"):
            if opt[key] is not None:
                opt[key] = mesh_lib.shard_state(opt[key], mesh)
    state.optimizer.load_state_dict(opt)
    state.step = int(saved["step"])
    return state


def load_checkpoint(path: str, device="cpu",
                    mesh: Optional[mesh_lib.Mesh] = None
                    ) -> Tuple[ExperimentConfig, DualEncoderModel]:
    """→ (config, eval-mode model on ``device`` with gradients off); under
    tensor parallel (``mesh``) each rank's shards of it, read on the host,
    so no rank holds the whole model."""
    meta = load_metadata(path)
    if meta.get("kind") != KIND:
        raise ValueError(
            f"{path}: checkpoint kind {meta.get('kind')!r} is not "
            f"{KIND!r}; convert HF encoders or a reference *.pt with "
            "speech_transcript_embeddings_torch.convert_checkpoint, and a "
            "JAX package (orbax) checkpoint with "
            "speech_transcript_embeddings_torch.bridge")
    cfg = ExperimentConfig.from_json(json.dumps(meta["config"]))
    axis = None if mesh is None else mesh.model_axis()
    with torch.device("meta"):
        model = DualEncoderModel(cfg.model, axis=axis)
    if axis is None:
        model.load_state_dict(_state_for(path, model, device), strict=True,
                              assign=True)
    else:
        load_into(path, model.to_empty(device=device), mesh)
    return cfg, model.to(device).eval().requires_grad_(False)


def load_stored_state(path: str) -> dict:
    """``model.pt`` on the host in the dtypes it was saved in, mapped from
    the file rather than read into memory."""
    return torch.load(os.path.join(path, "model.pt"), map_location="cpu",
                      weights_only=True, mmap=True)


def _check_kind(path: str) -> None:
    kind = load_metadata(path).get("kind")
    if kind != KIND:
        raise ValueError(f"{path}: checkpoint kind {kind!r} is not {KIND!r}")


def _state_for(path: str, model: torch.nn.Module, device) -> dict:
    """``model.pt`` with every tensor cast to ``model``'s parameter dtype."""
    _check_kind(path)
    state = torch.load(os.path.join(path, "model.pt"), map_location=device,
                       weights_only=True)
    target = dict(model.named_parameters())
    return {k: v.to(target[k].dtype) if k in target else v
            for k, v in state.items()}


@torch.no_grad()
def load_into(path: str, model: DualEncoderModel,
              mesh: Optional[mesh_lib.Mesh] = None) -> DualEncoderModel:
    """Copy a port checkpoint's weights into ``model`` in place, in the
    dtypes ``model`` stores them in, mapped straight to its device; under
    tensor parallel (``mesh``) read on the host, and each rank keeps its
    shards."""
    if mesh is None or mesh.model == 1:
        device = next(model.parameters()).device
        model.load_state_dict(_state_for(path, model, device), strict=True)
        return model
    _check_kind(path)
    target = dict(model.named_parameters())
    shards = mesh_lib.shard_state(load_stored_state(path), mesh)
    if set(shards) != set(target):
        raise ValueError(f"{path} holds other parameters than the model")
    for k, v in shards.items():
        target[k].copy_(v)
    return model
