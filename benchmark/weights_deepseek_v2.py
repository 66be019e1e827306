"""The weights of a run of a DeepSeek-V2 configuration, made by the benchmark
from ``--seed``: each tensor drawn on its own, from ``(seed, name)``,
directly in bf16 on the device, so that no fp32 copy of the whole model
(62 GB at DeepSeek-V2-Lite's size) is ever made. The program's serving
model is filled with them tensor by tensor (``fill``); the reference reads
the same values widened to fp32, one tensor at a time, when it needs them
(``getter``). Neither one's initialiser runs.

Names and kinds: the DeepSeek-V2 tower's (``tower_specs``) beside the
audio encoder's and the heads' of ``reference/model.py``'s ``param_specs``
(its text part left out). Scales are ``weights.py``'s (the configuration
file's ``init`` group) with one kind more: each expert's slice of a
stacked expert weight ``[experts, out, in]``, ``1/√in``. The router is a
dense ``[experts, hidden]`` weight, ``1/√hidden``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from benchmark.reference.model import param_specs
from benchmark.traffic import sub_seed
from benchmark.weights import _std

Spec = Tuple[Tuple[int, ...], str]


def tower_specs(t: dict) -> Dict[str, Spec]:
    """name → (shape, kind) of every weight of the DeepSeek-V2 tower of the
    published keys ``t``."""
    h, nh = t["hidden_size"], t["num_attention_heads"]
    nope, rope, vd = (t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                      t["v_head_dim"])
    rank, e, i = t["kv_lora_rank"], t["n_routed_experts"], \
        t["moe_intermediate_size"]
    out: Dict[str, Spec] = {
        "text_encoder.embed_tokens.weight": ((t["vocab_size"], h), "embed")}

    def mlp(p, width):
        out[f"{p}.gate_proj.weight"] = ((width, h), "dense")
        out[f"{p}.up_proj.weight"] = ((width, h), "dense")
        out[f"{p}.down_proj.weight"] = ((h, width), "dense")

    for layer in range(t["num_hidden_layers"]):
        p = f"text_encoder.layer_{layer}"
        out[f"{p}.input_layernorm.weight"] = ((h,), "norm_scale")
        a = f"{p}.self_attn"
        out[f"{a}.q_proj.weight"] = ((nh * (nope + rope), h), "dense")
        out[f"{a}.kv_a_proj_with_mqa.weight"] = ((rank + rope, h), "dense")
        out[f"{a}.kv_a_layernorm.weight"] = ((rank,), "norm_scale")
        out[f"{a}.kv_b_proj.weight"] = ((nh * (nope + vd), rank), "dense")
        out[f"{a}.o_proj.weight"] = ((h, nh * vd), "dense")
        out[f"{p}.post_attention_layernorm.weight"] = ((h,), "norm_scale")
        if layer >= t["first_k_dense_replace"] and \
                layer % t["moe_layer_freq"] == 0:
            out[f"{p}.mlp.gate.weight"] = ((e, h), "dense")
            out[f"{p}.mlp.experts.gate_up_proj"] = ((e, 2 * i, h), "experts")
            out[f"{p}.mlp.experts.down_proj"] = ((e, h, i), "experts")
            mlp(f"{p}.mlp.shared_experts", i * t["n_shared_experts"])
        else:
            mlp(f"{p}.mlp", t["intermediate_size"])
    out["text_encoder.norm.weight"] = ((h,), "norm_scale")
    return out


def specs(m: dict) -> Dict[str, Spec]:
    """Every weight of the dual encoder of ``m`` (a configuration's
    ``model`` group with a DeepSeek-V2 ``text``)."""
    stub = {"hidden_size": m["text"]["hidden_size"], "intermediate_size": 1,
            "vocab_size": 1, "max_position_embeddings": 1,
            "type_vocab_size": 1, "num_layers": 0, "num_heads": 1}
    rest = {k: v for k, v in param_specs(dict(m, text=stub)).items()
            if not k.startswith("text_encoder.")}
    return {**tower_specs(m["text"]), **rest}


def draw(name: str, spec: Spec, init: dict, seed: int, device
         ) -> torch.Tensor:
    """The bf16 tensor ``name`` of a run of ``seed``."""
    shape, kind = spec
    gen = torch.Generator(device).manual_seed(sub_seed(seed,
                                                       f"weights:{name}"))
    t = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.bfloat16)
    if kind == "norm_scale":
        return t.mul_(init["norm_jitter"]).add_(1.0)
    return t.mul_(shape[-1] ** -0.5 if kind == "experts"
                  else _std(kind, shape, init))


@torch.no_grad()
def fill(model: torch.nn.Module, config: dict, seed: int) -> None:
    """Copy every weight of a run of ``seed`` into ``model`` (built empty,
    on its device), one tensor at a time; a name or shape the model does
    not share with ``specs`` raises."""
    want = specs(config["model"])
    have = dict(model.named_parameters())
    if set(have) != set(want):
        raise ValueError("the model's weights are not the configuration's: "
                         f"{sorted(set(have) ^ set(want))[:8]}")
    for name, p in have.items():
        if tuple(p.shape) != tuple(want[name][0]):
            raise ValueError(f"{name}: {tuple(p.shape)} against "
                             f"{want[name][0]}")
        p.copy_(draw(name, want[name], config["init"], seed, p.device))


def getter(config: dict, seed: int, device
           ) -> Callable[[str], torch.Tensor]:
    """``name`` → the same weight in fp32 on ``device``, made anew at each
    call (the reference holds none between calls)."""
    want = specs(config["model"])
    return lambda name: draw(name, want[name], config["init"], seed,
                             device).float()
