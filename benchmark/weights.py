"""The weights of a run, made by the benchmark from ``--seed`` on the
device: one normal draw of every weight's elements from a ``torch.Generator``
on the card, cut into the reference's named tensors (``reference/model.py``
``param_specs``) and scaled by kind. The program and the reference both get
these tensors; neither one's initialiser runs.

Scales (the configuration file's ``init`` group): a dense weight
``1/√fan_in``, an embedding table ``1/√width``, a depthwise kernel
``1/√kernel``, a relative-distance table ``distance_std`` (large enough
that the relative_key bias moves the scores as much as the keys do), a
bias ``bias_std``, a LayerNorm scale ``1 ± norm_jitter``.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.model import param_specs
from benchmark.traffic import sub_seed


def _std(kind: str, shape, init: dict) -> float:
    if kind == "dense":
        return shape[1] ** -0.5
    if kind == "embed":
        return shape[1] ** -0.5
    if kind == "depthwise":
        return shape[-1] ** -0.5
    if kind == "distance":
        return init["distance_std"]
    if kind == "bias":
        return init["bias_std"]
    if kind == "norm_scale":
        return init["norm_jitter"]
    raise ValueError(f"unknown weight kind {kind!r}")


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name → fp32 tensor on ``device`` for the model of ``config`` (a
    configuration file), from ``seed``."""
    specs = param_specs(config["model"])
    total = sum(torch.Size(shape).numel() for shape, _ in specs.values())
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, kind) in specs.items():
        n = torch.Size(shape).numel()
        t = flat[at:at + n].view(shape)
        t.mul_(_std(kind, shape, config["init"]))
        if kind == "norm_scale":
            t.add_(1.0)
        out[name] = t
        at += n
    return out
