"""Freeze labels and the optimizer: AdamW with discriminative learning rates.

Port of ``speech_transcript_embeddings_tpu/training/optimizer.py``:

* ``param_labels`` labels every parameter of the port by name: ``frozen``
  (the bottom blocks of a partially unfrozen encoder, by layer index — the
  bridge unstacks the JAX ``bottom_stack``), ``encoder`` (the trainable
  encoder parameters) or ``head``; ``apply_freeze`` turns gradients off for
  the frozen split.
* ``linear_warmup_factor`` is the HF linear warmup → linear decay.
* ``AdamW`` is optax's ``chain(clip_by_global_norm, multi_transform({
  encoder: adamw(lr/divisor), head: adamw(lr)}))``, wrapped in
  ``MultiSteps`` for accumulation, written as plain tensor code because
  ``torch.optim.AdamW`` cannot keep its first moment in bf16
  (``OptimizerConfig.mu_dtype``): update = μ̂/(√ν̂ + eps) + wd·p, p −= lr·update,
  μ̂ from the fp32 μ before it is stored (rounded to ``mu_dtype``), weight
  decay on every trainable parameter. With accumulation over k micro-steps
  the mean gradient (Welford, as optax) is clipped and applied on every
  k-th call only, and the schedule counts updates, not micro-steps.
  ``state_dict``/``load_state_dict`` carry the whole state, as optax's
  ``MultiSteps`` state does, so a run preempted inside an accumulation
  window resumes with the same partial mean.

Under tensor parallel each rank holds the shards of its parameters, so μ, ν
and the accumulator are per shard (JAX's ``opt_state_shardings``), and the
clip's global norm sums each split leaf's squares over the model axis and
counts each replicated leaf once.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from speech_transcript_embeddings_torch.config import (
    FreezeConfig, ModelConfig, OptimizerConfig,
)
from speech_transcript_embeddings_torch.parallel.collectives import (
    ModelAxis, all_reduce_model,
)

FROZEN, ENCODER, HEAD = "frozen", "encoder", "head"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def label_for(name: str, freeze: FreezeConfig, model: ModelConfig) -> str:
    """The label of the port parameter ``name`` (dotted module path)."""
    parts = name.split(".")
    in_text, in_audio = parts[0] == "text_encoder", parts[0] == "audio_encoder"
    if not (in_text or in_audio):
        return HEAD
    if freeze.mode == "none":
        return ENCODER
    if freeze.mode == "full":
        return FROZEN
    if freeze.mode != "partial":
        raise ValueError(f"Unknown freeze mode {freeze.mode!r}")
    enc = model.text if in_text else model.audio
    keep = (freeze.text_layers_to_unfreeze if in_text
            else freeze.audio_layers_to_unfreeze)
    if len(parts) > 1 and parts[1].startswith("layer_"):
        idx = int(parts[1][len("layer_"):])
        if idx < enc.scan_bottom and enc.scan_bottom > max(
                enc.num_layers - keep, 0):
            # the JAX package scans these blocks as one stacked unit, which
            # must lie entirely inside the frozen prefix
            raise ValueError(
                f"scan_bottom={enc.scan_bottom} overlaps the {keep} unfrozen "
                f"top layers of a {enc.num_layers}-layer encoder")
        return FROZEN if idx < enc.num_layers - keep else ENCODER
    if in_text:
        return ENCODER if freeze.train_text_embeddings else FROZEN
    return ENCODER if freeze.train_audio_feature_projection else FROZEN


def param_labels(model: nn.Module, freeze: FreezeConfig,
                 model_cfg: ModelConfig) -> Dict[str, str]:
    return {name: label_for(name, freeze, model_cfg)
            for name, _ in model.named_parameters()}


def apply_freeze(model: nn.Module, labels: Dict[str, str]) -> None:
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != FROZEN)


def linear_warmup_factor(cfg: OptimizerConfig, total_steps: int
                         ) -> Callable[[int], np.float32]:
    """HF ``get_linear_schedule_with_warmup``: 0→1 over the warmup, then
    1→0 at ``total_steps`` (fp32, as the JAX schedule computes it)."""
    warmup = max(cfg.warmup_steps, 0)
    f32 = np.float32

    def factor(step: int) -> np.float32:
        step = min(step, total_steps)
        if step < warmup:
            return f32(step) / f32(max(warmup, 1))
        decay = f32(total_steps - step) / f32(max(total_steps - warmup, 1))
        return max(decay, f32(0.0))
    return factor


def global_norm(tensors: Iterable[torch.Tensor],
                sharded: Iterable[torch.Tensor] = (),
                axis: Optional[ModelAxis] = None) -> torch.Tensor:
    """√(Σ g²) over ``tensors`` (whole, or replicated over the model axis)
    and ``sharded`` (this rank's shards of split leaves, whose squared sums
    are summed over ``axis``)."""
    square = lambda ts: sum(torch.sum(g.float() * g.float()) for g in ts)
    total = square(tensors)
    parts = list(sharded)
    if parts:
        total = total + all_reduce_model(square(parts), axis)
    return torch.sqrt(total)


class AdamW:
    """The JAX ``make_optimizer`` over the trainable parameters
    (``params``: name → parameter, ``labels``: name → ``encoder``|``head``);
    under tensor parallel, ``sharded`` names the split ones, whose shards
    this rank holds on the model ``axis``."""

    def __init__(self, cfg: OptimizerConfig, freeze: FreezeConfig,
                 params: Dict[str, torch.Tensor], labels: Dict[str, str],
                 total_steps: int, accumulation_steps: int = 1,
                 axis: Optional[ModelAxis] = None,
                 sharded: frozenset = frozenset()):
        if any(labels[k] == FROZEN for k in params):
            raise ValueError("AdamW takes the trainable split only")
        self.cfg = cfg
        self.params = params
        self.axis = axis
        self.sharded = sharded
        self.factor = linear_warmup_factor(cfg, total_steps)
        encoder_scale = (1.0 / cfg.encoder_lr_divisor
                         if freeze.mode == "partial" else 1.0)
        # lr·scale as JAX forms it (a Python float), then fp32
        self.base_lr = {k: np.float32(cfg.learning_rate * (
            encoder_scale if labels[k] == ENCODER else 1.0)) for k in params}
        self.k = max(int(accumulation_steps), 1)
        self.mu_dtype = _DTYPES[cfg.mu_dtype] if cfg.mu_dtype else \
            torch.float32
        self.mu = {k: torch.zeros_like(p, dtype=self.mu_dtype)
                   for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()}
        self.acc = ({k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()} if self.k > 1 else None)
        self.mini_step = 0
        self.count = 0            # updates applied (the schedule's step)

    def state_dict(self) -> dict:
        """μ (in ``mu_dtype``), ν, the accumulator, ``mini_step`` and
        ``count``: everything a resumed run needs to continue exactly, a
        partial accumulation window included. The accumulator is all zeros
        at a window boundary (``mini_step`` 0), and then saved as None."""
        return {"mu": dict(self.mu), "nu": dict(self.nu),
                "acc": dict(self.acc) if self.mini_step else None,
                "mini_step": self.mini_step, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.params) or \
                set(state["nu"]) != set(self.params):
            raise ValueError("optimizer state is for other parameters")
        if state["acc"] is not None and self.acc is None or \
                not 0 <= state["mini_step"] < self.k:
            raise ValueError(f"optimizer state at micro-step "
                             f"{state['mini_step']} does not fit "
                             f"accumulation over {self.k} micro-steps")
        for k, p in self.params.items():
            self.mu[k] = state["mu"][k].to(p.device, self.mu_dtype)
            self.nu[k] = state["nu"][k].to(p.device, torch.float32)
            if self.acc is not None:
                if state["acc"] is None:
                    self.acc[k].zero_()
                else:
                    self.acc[k].copy_(state["acc"][k])
        self.mini_step = int(state["mini_step"])
        self.count = int(state["count"])

    def drop_moments(self) -> None:
        """Free μ, ν and the accumulator once training is over (the test
        phase needs the parameters only); ``count`` stays."""
        self.mu = self.nu = self.acc = None

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of a gradient of every trainable parameter."""
        return global_norm(
            (g for k, g in grads.items() if k not in self.sharded),
            (g for k, g in grads.items() if k in self.sharded), self.axis)

    def lr(self, name: str) -> np.float32:
        """The learning rate of the next update of ``name``."""
        return self.base_lr[name] * self.factor(self.count)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> bool:
        """One micro-step; returns True when it updated the parameters."""
        if self.acc is not None:
            n = self.mini_step
            for k, g in grads.items():
                a = self.acc[k]
                a.add_((g.float() - a) / (n + 1))
            self.mini_step = (n + 1) % self.k
            if self.mini_step != 0:
                return False
            grads = self.acc
        self._update(grads)
        if self.acc is not None:
            for a in self.acc.values():
                a.zero_()
        return True

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        c = self.cfg
        g_norm = self.global_norm(grads)
        keep = g_norm < c.max_grad_norm            # on the device: no sync
        count = self.count + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - np.power(f32(c.b1), f32(count)))
        bc2 = float(f32(1.0) - np.power(f32(c.b2), f32(count)))
        for k, p in self.params.items():
            g = grads[k].float()
            g = torch.where(keep, g, (g / g_norm) * c.max_grad_norm)
            # b1·μ in μ's stored dtype, then the fp32 sum (optax's order)
            mu = (1.0 - c.b1) * g + c.b1 * self.mu[k]
            nu = (1.0 - c.b2) * (g * g) + c.b2 * self.nu[k]
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + c.eps)
            upd = upd + c.weight_decay * p.float()
            p.add_((upd * float(-self.lr(k))).to(p.dtype))
            self.mu[k] = mu.to(self.mu_dtype)
            self.nu[k] = nu
        self.count = count
