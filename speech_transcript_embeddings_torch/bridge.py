"""Flax parameter tree ↔ the port's ``state_dict``.

The JAX model's params (a nested dict of arrays, as ``init_params`` or a
checkpoint restore returns them, converted to numpy) map onto the port's
module names one to one:

  * a Dense ``kernel [in, out]`` → ``weight [out, in]``,
  * a LayerNorm ``scale`` → ``weight``; an Embed ``embedding`` → ``weight``,
  * the depthwise ``depthwise_kernel [K, 1, H]`` → Conv1d layout ``[H, 1, K]``,
  * leaves under ``bottom_stack/scan/block`` carry a leading layer axis
    (``scan_bottom`` scanned blocks) and are unstacked into ``layer_i``,
  * bf16 leaves (``frozen_dtype``) become fp32.

``load_flax_params`` raises on any leaf the model does not use and on any
parameter the tree leaves unset. ``state_dict_to_flax`` is the inverse, in
the layout of a given config's ``scan_bottom``. This module needs numpy and
torch only: the tree is read through ``np.asarray``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from speech_transcript_embeddings_torch.models.layers import (
    Dense, Embed, LayerNorm,
)

STACK = ("bottom_stack", "scan", "block")
# Flax leaf name → (port name, axis permutation of one layer's array)
_LEAVES = {
    "kernel": ("weight", (1, 0)),
    "scale": ("weight", None),
    "embedding": ("weight", None),
    "depthwise_kernel": ("depthwise_kernel", (2, 1, 0)),
}
Entry = Tuple[Tuple[str, ...], Optional[int], Optional[Tuple[int, ...]]]


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def plan(params) -> Dict[str, Entry]:
    """torch key → (Flax path, stacked layer index or None, permutation)."""
    out: Dict[str, Entry] = {}

    def put(key, entry):
        if key in out:
            raise ValueError(f"two Flax leaves map to {key!r}")
        out[key] = entry

    for path, leaf in _flatten(params):
        name, perm = _LEAVES.get(path[-1], (path[-1], None))
        mods = list(path[:-1])
        starts = [s for s in range(len(mods) - 2)
                  if tuple(mods[s:s + 3]) == STACK]
        if not starts:
            put(".".join(mods + [name]), (path, None, perm))
            continue
        s = starts[0]
        for i in range(leaf.shape[0]):
            put(".".join(mods[:s] + [f"layer_{i}"] + mods[s + 3:] + [name]),
                (path, i, perm))
    return out


def _entry_shape(leaf_shape, layer, perm):
    shape = tuple(leaf_shape[1:] if layer is not None else leaf_shape)
    return tuple(shape[p] for p in perm) if perm else shape


def flax_shapes(params) -> Dict[str, Tuple[int, ...]]:
    """The port's parameter shapes that ``params`` provides (works on a tree
    of anything with ``.shape``, e.g. ``jax.eval_shape`` structs)."""
    leaves = dict(_flatten(params))
    return {k: _entry_shape(leaves[p].shape, i, perm)
            for k, (p, i, perm) in plan(params).items()}


def check_covers(model: nn.Module, shapes: Dict[str, Tuple[int, ...]]):
    """Raise unless ``shapes`` sets every parameter of ``model`` with its
    shape, and nothing else."""
    target = {k: tuple(p.shape) for k, p in model.named_parameters()}
    unused = sorted(set(shapes) - set(target))
    unset = sorted(set(target) - set(shapes))
    wrong = sorted(k for k in set(target) & set(shapes)
                   if target[k] != tuple(shapes[k]))
    if unused or unset or wrong:
        raise ValueError(
            f"Flax tree does not match the model: unused leaves {unused[:8]}"
            f"{'…' if len(unused) > 8 else ''} ({len(unused)}), unset "
            f"parameters {unset[:8]}{'…' if len(unset) > 8 else ''} "
            f"({len(unset)}), shape mismatches "
            f"{[(k, shapes[k], target[k]) for k in wrong[:8]]}")


def flax_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """fp32 CPU tensors keyed by the port's parameter names."""
    leaves = dict(_flatten(params))
    sd = {}
    for key, (path, layer, perm) in plan(params).items():
        a = np.asarray(leaves[path])
        if layer is not None:
            a = a[layer]
        if perm:
            a = a.transpose(perm)
        sd[key] = torch.from_numpy(np.array(a, dtype=np.float32))
    return sd


def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Copy a Flax param tree into ``model`` (cast to each parameter's
    dtype). Raises on unused leaves, unset parameters or wrong shapes."""
    sd = flax_to_state_dict(params)
    check_covers(model, {k: tuple(v.shape) for k, v in sd.items()})
    model.load_state_dict(sd, strict=True)
    return model


def state_dict_to_flax(model: nn.Module, model_cfg) -> dict:
    """The inverse: a nested dict of fp32 numpy arrays in the JAX layout,
    with the first ``scan_bottom`` blocks of each encoder restacked under
    ``bottom_stack/scan/block``."""
    flat: Dict[Tuple[str, ...], np.ndarray] = {}
    for name, mod in model.named_modules():
        for pname, param in mod.named_parameters(recurse=False):
            leaf = pname
            if pname == "weight":
                leaf = ("kernel" if isinstance(mod, Dense) else
                        "scale" if isinstance(mod, LayerNorm) else
                        "embedding" if isinstance(mod, Embed) else pname)
            perm = _LEAVES.get(leaf, (None, None))[1]
            a = param.detach().float().cpu().numpy()
            path = (tuple(name.split(".")) if name else ()) + (leaf,)
            flat[path] = a.transpose(perm) if perm else a

    scans = {"text_encoder": model_cfg.text.scan_bottom,
             "audio_encoder": model_cfg.audio.scan_bottom}
    tree: dict = {}
    stacked: Dict[Tuple[str, ...], list] = {}
    for path, a in flat.items():
        n = scans.get(path[0], 0)
        if len(path) > 2 and path[1].startswith("layer_") and \
                int(path[1][len("layer_"):]) < n:
            stacked.setdefault((path[0],) + STACK + path[2:], []).append(
                (int(path[1][len("layer_"):]), a))
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    for path, items in stacked.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([a for _, a in sorted(items)])
    return tree
