"""The plain reference of the DeepSeek-V2 transcript tower, its attentive
pooling and its projection: the forward of the published
``modeling_deepseek.py`` (``deepseek_v2``) written out in plain PyTorch.

It imports nothing but ``torch`` and ``math``: no kernel or module of the
program. It reads the model's widths from a configuration's ``model`` group
(a dict: ``text`` holds the published keys, ``heads`` the heads') and its
weights through ``get(name)``, which returns one fp32 tensor by the name
the program's state dict gives it. Nothing is kept between calls of
``get``, so the tower can run layer by layer with each weight made when it
is needed: the fp32 model (62 GB at DeepSeek-V2-Lite's size) never sits on
the card at once.

Every product runs in fp32 (the caller turns TF32 off); the router takes
its own fp32 logits; the experts run in a loop over the experts with
boolean masks; attention is the explicit softmax of the scores under the
causal and key-padding mask, as the published model builds it. Departures
from the published forward: none. (The published model has no pooling or
projection: those are the port's heads, here as ``pool`` and ``project``.)
``precision="fp8"`` rounds both operands of every product to float8 e4m3
with a per-tensor scale, the control that a lower precision than the
configuration's is caught.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

FP8_MAX = 448.0          # the largest float8 e4m3 value
NEG_HEAD = -1e9          # the pooling's masked score


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


# ---- rope -------------------------------------------------------------------

def _yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_find_correction_dim(num_rotations, dim, base, max_position):
    return (dim * math.log(max_position / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_inv_freq(t: dict) -> torch.Tensor:
    """The YaRN inverse frequencies of the rotary dims (fp32, host)."""
    r, dim, base = t["rope_scaling"], t["qk_rope_head_dim"], t["rope_theta"]
    pos = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** pos)
    freq_inter = 1.0 / (r["factor"] * base ** pos)
    low = math.floor(_yarn_find_correction_dim(
        r["beta_fast"], dim, base, r["original_max_position_embeddings"]))
    high = math.ceil(_yarn_find_correction_dim(
        r["beta_slow"], dim, base, r["original_max_position_embeddings"]))
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def cos_sin(t: dict, length: int, device):
    """cos, sin ``[length, qk_rope_head_dim]`` at positions 0…length−1."""
    r = t["rope_scaling"]
    freqs = torch.outer(torch.arange(length, dtype=torch.float32),
                        yarn_inv_freq(t))
    emb = torch.cat((freqs, freqs), dim=-1)
    m = (_yarn_get_mscale(r["factor"], r["mscale"])
         / _yarn_get_mscale(r["factor"], r["mscale_all_dim"]))
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def softmax_scale(t: dict) -> float:
    scale = (t["qk_nope_head_dim"] + t["qk_rope_head_dim"]) ** -0.5
    r = t["rope_scaling"]
    if r.get("mscale_all_dim"):
        m = _yarn_get_mscale(r["factor"], r["mscale_all_dim"])
        scale = scale * m * m
    return scale


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def rope(x, cos, sin):
    """``x [B, heads, T, d]``: the published interleaved pairs regrouped
    (even features first, then odd), then ``x·cos + rotate_half(x)·sin``."""
    x = torch.cat((x[..., 0::2], x[..., 1::2]), dim=-1)
    return x * cos[None, None] + _rotate_half(x) * sin[None, None]


# ---- the tower --------------------------------------------------------------

class Tower:
    """The tower, pooling and projection of a configuration's ``model``
    group ``m`` over the weights ``get`` returns. ``routes``: each MoE
    layer's top-k experts ``[tokens, k]`` of the last call."""

    def __init__(self, m: dict, get: Callable[[str], torch.Tensor],
                 precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m, self.t, self.get = m, m["text"], get
        self.q = (lambda x: x) if precision == "fp32" else _fp8
        self.routes: Dict[int, torch.Tensor] = {}

    def linear(self, name, x, bias=False):
        y = self.q(x) @ self.q(self.get(f"{name}.weight")).t()
        return y + self.get(f"{name}.bias") if bias else y

    def rms_norm(self, name, x):
        var = x.pow(2).mean(-1, keepdim=True)
        return self.get(f"{name}.weight") * (
            x * torch.rsqrt(var + self.t["rms_norm_eps"]))

    def mlp(self, p, x):
        return self.linear(f"{p}.down_proj", torch.nn.functional.silu(
            self.linear(f"{p}.gate_proj", x)) * self.linear(f"{p}.up_proj", x))

    def attention(self, p, x, mask, cos, sin):
        t = self.t
        b, n, _ = x.shape
        nh, nope, rd, vd = (t["num_attention_heads"], t["qk_nope_head_dim"],
                            t["qk_rope_head_dim"], t["v_head_dim"])
        q = self.linear(f"{p}.q_proj", x).view(b, n, nh, nope + rd)
        q = q.transpose(1, 2)
        q_nope, q_pe = torch.split(q, [nope, rd], dim=-1)
        ckv = self.linear(f"{p}.kv_a_proj_with_mqa", x)
        ckv, k_pe = torch.split(ckv, [t["kv_lora_rank"], rd], dim=-1)
        k_pe = k_pe.view(b, n, 1, rd).transpose(1, 2)
        kv = self.linear(f"{p}.kv_b_proj",
                         self.rms_norm(f"{p}.kv_a_layernorm", ckv))
        kv = kv.view(b, n, nh, nope + vd).transpose(1, 2)
        k_nope, v = torch.split(kv, [nope, vd], dim=-1)
        q_pe, k_pe = rope(q_pe, cos, sin), rope(k_pe, cos, sin)
        query = torch.cat([q_nope, q_pe], dim=-1)
        key = torch.cat([k_nope, k_pe.expand(b, nh, n, rd)], dim=-1)
        scores = (self.q(query) @ self.q(key).transpose(2, 3)
                  ) * softmax_scale(t)
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        allowed = causal[None, None] & mask[:, None, None, :].bool()
        scores = scores.masked_fill(~allowed, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1)
        out = (self.q(probs) @ self.q(v)).transpose(1, 2).reshape(b, n, nh * vd)
        return self.linear(f"{p}.o_proj", out)

    def moe(self, i, p, x):
        t = self.t
        b, n, h = x.shape
        flat = x.reshape(-1, h)
        gate = self.get(f"{p}.gate.weight")
        scores = torch.softmax(self.q(flat) @ self.q(gate).t(), dim=-1)
        weights, experts = torch.topk(scores, t["num_experts_per_tok"],
                                      dim=-1)
        if t["num_experts_per_tok"] > 1 and t["norm_topk_prob"]:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        else:
            weights = weights * t["routed_scaling_factor"]
        self.routes[i] = experts
        gate_up = self.get(f"{p}.experts.gate_up_proj")
        down = self.get(f"{p}.experts.down_proj")
        width = t["moe_intermediate_size"]
        y = torch.zeros_like(flat)
        for e in range(t["n_routed_experts"]):
            chosen = experts == e                         # [tokens, k]
            rows = chosen.any(dim=-1)
            if not bool(rows.any()):
                continue
            xe = flat[rows]
            g = self.q(xe) @ self.q(gate_up[e, :width]).t()
            u = self.q(xe) @ self.q(gate_up[e, width:]).t()
            ye = self.q(torch.nn.functional.silu(g) * u) @ self.q(down[e]).t()
            y[rows] += (weights * chosen)[rows].sum(-1, keepdim=True) * ye
        del gate_up, down
        return (y + self.mlp(f"{p}.shared_experts", flat)).view(b, n, h)

    def layer(self, i, x, mask, cos, sin):
        t, p = self.t, f"text_encoder.layer_{i}"
        x = x + self.attention(f"{p}.self_attn",
                               self.rms_norm(f"{p}.input_layernorm", x),
                               mask, cos, sin)
        h = self.rms_norm(f"{p}.post_attention_layernorm", x)
        if i >= t["first_k_dense_replace"] and i % t["moe_layer_freq"] == 0:
            return x + self.moe(i, f"{p}.mlp", h)
        return x + self.mlp(f"{p}.mlp", h)

    def hidden(self, ids, mask):
        """The final RMSNorm's hidden states ``[B, T, H]`` of right-padded
        ``ids`` (``mask`` 1 on valid tokens)."""
        x = self.get("text_encoder.embed_tokens.weight")[ids]
        cos, sin = cos_sin(self.t, ids.shape[1], ids.device)
        for i in range(self.t["num_hidden_layers"]):
            x = self.layer(i, x, mask, cos, sin)
        return self.rms_norm("text_encoder.norm", x)

    # -- the port's heads
    def pool(self, hidden, mask):
        if not self.m["heads"]["use_attentive_pooling"]:
            return hidden[:, 0]
        s = self.linear("text_pooling.score_out", torch.tanh(
            self.linear("text_pooling.score_in", hidden, True)), True)[..., 0]
        s = s.masked_fill(~mask.bool(), NEG_HEAD)
        return torch.einsum("bt,bth->bh", torch.softmax(s, -1), hidden)

    def project(self, x):
        x = torch.nn.functional.gelu(self.linear("text_projection.dense_in",
                                                 x, True))
        x = self.linear("text_projection.dense_out", x, True)
        return torch.nn.functional.layer_norm(
            x, x.shape[-1:], self.get("text_projection.norm.weight"),
            self.get("text_projection.norm.bias"), 1e-5)

    def embed(self, ids, mask):
        """The serving embedding of each transcript, L2-normalised
        ``[B, D]``."""
        x = self.project(self.pool(self.hidden(ids, mask), mask))
        return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
