"""Port checkpoints: ``metadata.json`` (the JAX schema) + ``model.pt``.

``metadata.json`` carries ``format_version``, ``kind``, ``info`` and the full
``ExperimentConfig`` as JSON, like the JAX package's checkpoints
(``training/checkpoints.py``), with ``kind = "torch_params"``; ``model.pt``
is ``torch.save`` of the model's ``state_dict`` in the dtypes it is stored
in (a trained model: fp32 trainable parameters, the frozen split in its
frozen dtype). Loading casts every tensor to the storage of the model it
goes into: ``load_checkpoint`` to the serving storage (Dense and Embed
weights in the compute dtype), ``load_into`` to a given model's. Orbax
checkpoints are not read here: bring one across with ``bridge.py`` in a
process that has JAX.
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

FORMAT_VERSION = 1
KIND = "torch_params"


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "metadata.json"))


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, "metadata.json")) as f:
        return json.load(f)


def save_checkpoint(path: str, model: DualEncoderModel, cfg: ExperimentConfig,
                    info: Optional[dict] = None) -> None:
    """Write atomically: into ``path.tmp``, then rename over ``path``."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(model.state_dict(), os.path.join(tmp, "model.pt"))
    meta = {"format_version": FORMAT_VERSION, "kind": KIND,
            "info": info or {}, "config": json.loads(cfg.to_json())}
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cpu"
                    ) -> Tuple[ExperimentConfig, DualEncoderModel]:
    """→ (config, eval-mode model on ``device`` with gradients off)."""
    meta = load_metadata(path)
    if meta.get("kind") != KIND:
        raise ValueError(
            f"{path}: checkpoint kind {meta.get('kind')!r} is not "
            f"{KIND!r}; convert JAX checkpoints with "
            "speech_transcript_embeddings_torch.bridge")
    cfg = ExperimentConfig.from_json(json.dumps(meta["config"]))
    with torch.device("meta"):
        model = DualEncoderModel(cfg.model)
    model.load_state_dict(_state_for(path, model, device), strict=True,
                          assign=True)
    return cfg, model.to(device).eval().requires_grad_(False)


def _state_for(path: str, model: torch.nn.Module, device) -> dict:
    """``model.pt`` with every tensor cast to ``model``'s parameter dtype."""
    meta = load_metadata(path)
    if meta.get("kind") != KIND:
        raise ValueError(f"{path}: checkpoint kind {meta.get('kind')!r} is "
                         f"not {KIND!r}")
    state = torch.load(os.path.join(path, "model.pt"), map_location=device,
                       weights_only=True)
    target = dict(model.named_parameters())
    return {k: v.to(target[k].dtype) if k in target else v
            for k, v in state.items()}


@torch.no_grad()
def load_into(path: str, model: DualEncoderModel) -> DualEncoderModel:
    """Copy a port checkpoint's weights into ``model`` in place, in the
    dtypes ``model`` stores them in."""
    device = next(model.parameters()).device
    model.load_state_dict(_state_for(path, model, device), strict=True)
    return model
