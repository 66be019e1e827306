"""Model FLOPs of a DeepSeek-V2 transcript tower's forward, its attentive
pooling and its projection, counted from a configuration's widths at each
transcript's valid tokens: what the model's mathematics needs (2 FLOP a
multiply-add of every matrix product), whatever the program dispatches.
Pads, norms, rope, softmaxes and elementwise work are not counted.

Per valid token and layer: the MLA products (``q``, the compressed KV and
the shared rotary key, its decompression, the output), the causal
attention's scores and value sum (token ``j`` of a transcript attends to
``j`` tokens); the dense layers' SwiGLU; in a MoE layer the router, the
``num_experts_per_tok`` routed experts' SwiGLU and the shared experts'.
Per transcript: the pooling's scores at each valid token, the projection
once.
"""

from __future__ import annotations

from typing import Sequence


def _transcript(config: dict, n: int) -> float:
    m = config["model"]
    t, heads = m["text"], m["heads"]
    h, nh = t["hidden_size"], t["num_attention_heads"]
    qk = t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
    vd, rank = t["v_head_dim"], t["kv_lora_rank"]
    pairs = n * (n + 1) / 2                 # causal (query, key) pairs
    attention = 2 * n * (h * nh * qk + h * (rank + t["qk_rope_head_dim"])
                         + rank * nh * (t["qk_nope_head_dim"] + vd)
                         + nh * vd * h) + 2 * pairs * nh * (qk + vd)
    swiglu = lambda width: 3 * 2 * n * h * width
    total = 0.0
    for layer in range(t["num_hidden_layers"]):
        total += attention
        if layer >= t["first_k_dense_replace"] and \
                layer % t["moe_layer_freq"] == 0:
            i = t["moe_intermediate_size"]
            total += (2 * n * h * t["n_routed_experts"]
                      + t["num_experts_per_tok"] * swiglu(i)
                      + swiglu(i * t["n_shared_experts"]))
        else:
            total += swiglu(t["intermediate_size"])
    d = heads["projection_dim"]
    hidden = heads.get("projection_hidden_dim") or 2 * d
    if heads["use_attentive_pooling"]:
        total += 2 * n * (h * (h // 2) + h // 2)
    return total + 2 * (h * hidden + hidden * d)


def embed_text(config: dict, lengths: Sequence[int]) -> float:
    """FLOPs of embedding transcripts of ``lengths`` valid tokens."""
    return sum(_transcript(config, int(n)) for n in lengths)
