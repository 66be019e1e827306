"""Train and eval steps.

Port of ``speech_transcript_embeddings_tpu/training/train_step.py``. One
``train_step`` call = host batch in → log-mel frontend on the device (no
gradient) → ``forward_pos_neg`` with dropout and SpecAugment drawn from the
step's generator → contrastive loss → gradients of the trainable split only
(the frozen split has ``requires_grad`` off, so autograd never computes its
gradients) → the optimizer's micro-step. The state holds the model itself:
trainable parameters in fp32, the frozen split rounded once to
``resolve_frozen_dtype(cfg)``, and the optimizer's moments. On a mesh
(``state.mesh``) the loss gathers and the gradient mean run over the data
axis only; under tensor parallel the model holds this rank's shards, the
model axis's collectives run inside its forward and backward, and the grad
norm counts each split leaf once across its shards.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from speech_transcript_embeddings_torch.config import ExperimentConfig
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel,
)
from speech_transcript_embeddings_torch.parallel import collectives
from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
from speech_transcript_embeddings_torch.training import losses
from speech_transcript_embeddings_torch.training import optimizer as opt_lib

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    model: DualEncoderModel
    labels: Dict[str, str]
    trainable: Dict[str, torch.nn.Parameter]
    frozen: Dict[str, torch.nn.Parameter]
    optimizer: opt_lib.AdamW
    step: int = 0                      # micro-steps taken
    mesh: Optional[mesh_lib.Mesh] = None   # None: every rank on the data axis


def resolve_frozen_dtype(cfg: ExperimentConfig) -> str:
    """FreezeConfig.frozen_dtype, defaulting to the model compute dtype."""
    return cfg.freeze.frozen_dtype or cfg.model.dtype


@torch.no_grad()
def create_train_state(model: DualEncoderModel, cfg: ExperimentConfig,
                       total_steps: int,
                       mesh: Optional[mesh_lib.Mesh] = None) -> TrainState:
    """Label and freeze ``model`` (the training form of ``init_model``,
    built on ``mesh``'s model axis under tensor parallel), round every
    frozen parameter once to the frozen dtype (LayerNorm scales, distance
    embeddings and depthwise kernels included, as JAX casts its whole
    frozen split), and build the optimizer."""
    labels = opt_lib.param_labels(model, cfg.freeze, cfg.model)
    opt_lib.apply_freeze(model, labels)
    frozen_dtype = _DTYPES[resolve_frozen_dtype(cfg)]
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        if labels[name] == opt_lib.FROZEN:
            p.data = p.data.to(frozen_dtype)
            frozen[name] = p
        else:
            trainable[name] = p
    axis = model.axis
    sharded = frozenset(k for k in trainable if axis is not None
                        and mesh_lib.shard_dim(k) is not None)
    tx = opt_lib.AdamW(cfg.optimizer, cfg.freeze, trainable, labels,
                       total_steps, cfg.train.accumulation_steps, axis,
                       sharded)
    return TrainState(model, labels, trainable, frozen, tx, mesh=mesh)


def _to_device(a, device) -> torch.Tensor:
    """A host array, or a tensor already placed (a benchmark's
    device-resident batch), on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


def model_batch_from_host(frontend, batch: dict, device) -> dict:
    """Run the frontend on the device (no gradient) and assemble the
    model's batch dict from a host batch of numpy arrays."""
    with torch.no_grad():
        features, audio_mask = frontend(_to_device(batch["waveform"], device),
                                        _to_device(batch["num_samples"],
                                                   device))
    out = {k: _to_device(batch[k], device) for k in (
        "input_ids_pos", "attention_mask_pos", "input_ids_neg",
        "attention_mask_neg")}
    out["input_features"] = features
    out["attention_mask_audio"] = audio_mask
    return out


def data_axis() -> Optional[str]:
    """``"data"`` under a process group, None in one process."""
    return "data" if collectives.initialized() else None


def data_group(mesh: Optional[mesh_lib.Mesh]):
    """The process group of ``mesh``'s data axis (None: every rank)."""
    return None if mesh is None else mesh.data_group


def train_step(cfg: ExperimentConfig, state: TrainState, frontend,
               batch: dict, generator: Optional[torch.Generator]) -> dict:
    """One micro-step → metrics (device tensors: no host sync): ``loss``,
    ``clean_hr``, ``corrupt_hr`` (this rank's rows under data parallel)
    and ``grad_norm`` of this micro-batch's raw gradient (averaged over the
    data axis)."""
    device = next(iter(state.trainable.values())).device
    axis, group = data_axis(), data_group(state.mesh)
    mb = model_batch_from_host(frontend, batch, device)
    out = state.model.forward_pos_neg(mb, generator)
    loss, aux = losses.compute_loss(cfg.loss, out, axis, group)
    params = list(state.trainable.values())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(state.trainable.items(), grads)}
    if axis is not None:
        collectives.all_reduce_mean_(list(grads.values()), group)
    grad_norm = state.optimizer.global_norm(grads)
    state.optimizer.step(grads)
    state.step += 1
    t = cfg.loss.temperature
    return {"loss": loss.detach(),
            "clean_hr": losses.to_human_readable(aux.s_pos.detach(), t).mean(),
            "corrupt_hr": losses.to_human_readable(aux.s_neg.detach(),
                                                   t).mean(),
            "grad_norm": grad_norm}


def _per_sample_eval_loss(cfg, aux: losses.LossAux, alignment_scores):
    """Per-sample 2-way CE (+ alignment factor + corrupt penalty): CE over
    [s_pos, s_neg]/τ == softplus((s_neg − s_pos)/τ)."""
    per = F.softplus((aux.s_neg - aux.s_pos) / cfg.temperature)
    factor = losses.alignment_factor(alignment_scores, cfg.alignment_weight)
    if factor is not None:
        per = per * factor
    if cfg.corrupt_gamma > 0:
        per = per + cfg.corrupt_gamma * F.relu(aux.s_neg)
    return per


@torch.no_grad()
def eval_step(cfg: ExperimentConfig, model: DualEncoderModel, frontend,
              batch: dict, mesh: Optional[mesh_lib.Mesh] = None) -> dict:
    """Per-batch sums and raw cosines (JAX ``make_eval_step``): ``loss_sum``
    is the training objective (the masked in-batch InfoNCE for
    ``kind='global'``, the pairwise CE otherwise), ``pairwise_loss_sum``
    the pairwise CE in both modes. Under data parallel the sums and cosines
    are this rank's rows (the caller sums over ``mesh``'s data axis), each
    scored against the whole batch's candidates for ``kind='global'``."""
    device = next(model.parameters()).device
    mb = model_batch_from_host(frontend, batch, device)
    out = model.forward_pos_neg(mb, None)
    aux = losses.LossAux(s_pos=torch.sum(out.audio * out.text_pos, -1),
                         s_neg=torch.sum(out.audio * out.text_neg, -1))
    per_pair = _per_sample_eval_loss(cfg.loss, aux, out.alignment_scores)
    m = _to_device(batch["example_mask"], device)
    if cfg.loss.kind == "global":
        per_obj = losses.global_per_sample_masked(
            cfg.loss, out.text_pos, out.text_neg, out.audio, m,
            out.alignment_scores, data_axis(), data_group(mesh))
    else:
        per_obj = per_pair
    return {"loss_sum": torch.sum(per_obj * m),
            "pairwise_loss_sum": torch.sum(per_pair * m),
            "count": torch.sum(m), "s_pos": aux.s_pos, "s_neg": aux.s_neg,
            "example_mask": m}
