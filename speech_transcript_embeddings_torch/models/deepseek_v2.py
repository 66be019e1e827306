"""DeepSeek-V2 as the transcript tower: a causal decoder of pre-RMSNorm
residual layers, latent attention (MLA) and sparse experts.

The port's own tower (the JAX package has none), written from the layer
equations of the published ``modeling_deepseek.py`` at a
``DeepseekV2TextConfig``:

* ``RMSNorm``: ``x·rsqrt(mean(x²) + eps)·w`` in fp32, output in the compute
  dtype.
* ``LatentAttention``: ``q = W_q·x`` → per head ``qk_nope_head_dim`` +
  ``qk_rope_head_dim``; ``[c_kv; k_pe] = W_kv_a·x``; ``c_kv`` through its
  own RMSNorm, then ``W_kv_b`` → per head ``k_nope`` and ``v``; ``k_pe`` is
  one head shared by all; rope on ``q_pe`` and ``k_pe`` only, after
  DeepSeek's de-interleave (pairs ``(x0, x1), (x2, x3) …`` → ``x0 x2 … x1
  x3 …``) with YaRN frequencies; the softmax scale is
  ``(nope + rope)^-½ · mscale²``. Positions run 0…T−1 and the mask is
  causal: with right padding a valid token never sees a pad.
  ``F.scaled_dot_product_attention`` with ``is_causal`` and the explicit
  scale, its backend left to PyTorch's dispatch: for 192-wide queries and
  keys against 128-wide values in bf16 on an H100 (torch 2.11) that is
  cuDNN's attention; on the CPU the plain math path.
* ``MoE``: a router in fp32 (softmax over ``n_routed_experts`` logits,
  greedy top-``num_experts_per_tok``, renormalised only under
  ``norm_topk_prob``, else times ``routed_scaling_factor``); the (token,
  choice) rows sorted by expert in one sort and gathered; the routed SwiGLU
  experts as grouped products (``torch._grouped_mm`` on a CUDA device,
  else a loop over experts); each token's outputs weighted and summed over
  its choices in one batched product (fp32 sums; the weights rounded to the
  compute dtype, where the published code multiplies in fp32 after
  rounding the outputs); plus the shared experts as one SwiGLU
  ``n_shared_experts`` times as wide. No token is dropped. The per-expert
  row counts of the last call stay on the device as ``MoE.expert_rows``
  (the layer's counter; the grouped product needs them anyway).
* Layers ``0 … first_k_dense_replace − 1`` hold a dense SwiGLU instead.

Under a profiler each layer opens the spans ``text_attention`` (input norm,
the MLA products, the latent norm, rope, attention, output product),
``moe_route`` (router product, softmax, top-k, the sort, the gather),
``moe_experts`` (the routed products and the weighted combine) and
``text_mlp`` (the shared experts, the dense layer's MLP). Blocks are
``layer_<i>`` (the freeze labels read the index) and are rematerialised
under ``remat`` as ``TextEncoder``'s are. There is no dropout. Tensor
parallel and int8 serving are not supported for this tower.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from speech_transcript_embeddings_torch.config import DeepseekV2TextConfig
from speech_transcript_embeddings_torch.models.layers import Dense, Embed
from speech_transcript_embeddings_torch.utils.profile import span


def check_supported(c: DeepseekV2TextConfig) -> None:
    """Raise on a published option this tower does not implement."""
    unsupported = {
        "q_lora_rank": c.q_lora_rank is not None,
        "topk_method": c.topk_method != "greedy",
        "n_group, topk_group": (c.n_group, c.topk_group) != (1, 1),
        "scoring_func": c.scoring_func != "softmax",
        "hidden_act": c.hidden_act != "silu",
        "rope_scaling.type": c.rope_scaling.type != "yarn",
        "attention_bias": c.attention_bias,
        "num_key_value_heads":
            c.num_key_value_heads != c.num_attention_heads,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError("the DeepSeek-V2 tower implements the published "
                         "DeepSeek-V2-Lite options only; not these: "
                         + ", ".join(bad))


# ---- rope -------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(c: DeepseekV2TextConfig, device="cpu") -> torch.Tensor:
    """The YaRN inverse frequencies ``[qk_rope_head_dim / 2]`` (fp32): the
    base frequencies where a dimension turns more than ``beta_fast`` times
    over the original context, the interpolated ones (÷ ``factor``) where
    it turns fewer than ``beta_slow`` times, a linear ramp between."""
    r, dim, base = c.rope_scaling, c.qk_rope_head_dim, c.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (r.factor * base ** exps)

    def dim_of(rotations):
        return (dim * math.log(r.original_max_position_embeddings
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(dim_of(r.beta_fast)), 0)
    high = min(math.ceil(dim_of(r.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_table(c: DeepseekV2TextConfig, length: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[length, qk_rope_head_dim]`` in fp32 at positions
    0…length−1, scaled by the ratio of the two YaRN mscales; made on
    ``device`` (no copy from the host)."""
    r = c.rope_scaling
    t = torch.arange(length, dtype=torch.float32, device=device)
    freqs = torch.outer(t, yarn_inv_freq(c, device))
    emb = torch.cat([freqs, freqs], dim=-1)
    m = yarn_mscale(r.factor, r.mscale) / yarn_mscale(r.factor,
                                                      r.mscale_all_dim)
    return emb.cos() * m, emb.sin() * m


def softmax_scale(c: DeepseekV2TextConfig) -> float:
    """``(nope + rope)^-½`` times YaRN's ``mscale_all_dim`` term squared."""
    scale = (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5
    r = c.rope_scaling
    if r.mscale_all_dim:
        scale *= yarn_mscale(r.factor, r.mscale_all_dim) ** 2
    return scale


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """DeepSeek's ``view(…, d/2, 2).transpose``: the even features, then the
    odd ones."""
    d = x.shape[-1]
    return x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rope on ``x [B, T, heads, d]`` after the de-interleave, in fp32;
    → ``x``'s dtype. ``cos``, ``sin``: ``[T, d]``."""
    dtype = x.dtype
    x = deinterleave(x).float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return (x * cos + rotated * sin).to(dtype)


# ---- layers -----------------------------------------------------------------

class RMSNorm(nn.Module):
    """``x·rsqrt(mean(x²) + eps)·w``: statistics and scale in fp32 (the
    weight is stored fp32), output in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.weight.shape, self.weight.float(),
                          self.eps).to(self.dtype)


class MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) · up(x))``."""

    def __init__(self, hidden: int, width: int, dtype, param_dtype):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, param_dtype=param_dtype)
        self.gate_proj = Dense(hidden, width, **kw)
        self.up_proj = Dense(hidden, width, **kw)
        self.down_proj = Dense(width, hidden, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LatentAttention(nn.Module):
    """Multi-head latent attention without query compression."""

    def __init__(self, c: DeepseekV2TextConfig, dtype, param_dtype):
        super().__init__()
        self.c = c
        h, nh = c.hidden_size, c.num_attention_heads
        kw = dict(use_bias=False, dtype=dtype, param_dtype=param_dtype)
        self.q_proj = Dense(h, nh * (c.qk_nope_head_dim + c.qk_rope_head_dim),
                            **kw)
        self.kv_a_proj_with_mqa = Dense(h, c.kv_lora_rank + c.qk_rope_head_dim,
                                        **kw)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps, dtype)
        self.kv_b_proj = Dense(c.kv_lora_rank,
                               nh * (c.qk_nope_head_dim + c.v_head_dim), **kw)
        self.o_proj = Dense(nh * c.v_head_dim, h, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
        c = self.c
        b, t, _ = x.shape
        nh, nope, rope = (c.num_attention_heads, c.qk_nope_head_dim,
                          c.qk_rope_head_dim)
        q = self.q_proj(x).view(b, t, nh, nope + rope)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        c_kv, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, rope],
                                                      dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv)).view(
            b, t, nh, nope + c.v_head_dim)
        k_nope, v = kv.split([nope, c.v_head_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe.expand(b, t, nh, rope)],
                      dim=-1).transpose(1, 2)
        out = F.scaled_dot_product_attention(
            q, k, v.transpose(1, 2), is_causal=True, scale=softmax_scale(c))
        return self.o_proj(out.transpose(1, 2).reshape(b, t, nh * c.v_head_dim))


class Router(nn.Module):
    """The gate: logits ``x·Wᵀ`` in fp32 over ``n_routed_experts``, then
    ``route``. ``weight [experts, hidden]``."""

    def __init__(self, c: DeepseekV2TextConfig, dtype, param_dtype):
        super().__init__()
        self.c = c
        self.weight = nn.Parameter(torch.empty(
            c.n_routed_experts, c.hidden_size, dtype=param_dtype or dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return route(F.linear(x.float(), self.weight.float()), self.c)


def route(logits: torch.Tensor, c: DeepseekV2TextConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax scores, greedy top-k → (weights ``[N, k]`` fp32, experts
    ``[N, k]``): renormalised to sum 1 under ``norm_topk_prob``, else times
    ``routed_scaling_factor``."""
    scores = logits.softmax(dim=-1)
    weights, experts = torch.topk(scores, c.num_experts_per_tok, dim=-1)
    if c.num_experts_per_tok > 1 and c.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        weights = weights * c.routed_scaling_factor
    return weights, experts


def dispatch(experts: torch.Tensor, num_experts: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (token, choice) rows in expert order: → (``order``, the flat
    row index of each sorted row, and the rows of each expert ``[E]``), one
    sort, no host sync."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(num_experts, dtype=torch.int64,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    return order, counts


def grouped_products(rows: torch.Tensor, counts: torch.Tensor,
                     gate_up: torch.Tensor, down: torch.Tensor
                     ) -> torch.Tensor:
    """Each expert's SwiGLU over its rows (``rows`` sorted by expert,
    ``counts`` of each): ``gate_up [E, 2I, H]`` (gate rows first),
    ``down [E, H, I]``. Grouped products on a CUDA device where torch has
    ``_grouped_mm`` (offsets on the device, no host sync); else a loop over
    the experts (the counts read on the host)."""
    width = down.shape[-1]
    if rows.is_cuda and hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(counts, 0, dtype=torch.int32)
        gu = torch._grouped_mm(rows, gate_up.transpose(-2, -1), offs=offs)
        h = F.silu(gu[:, :width]) * gu[:, width:]
        return torch._grouped_mm(h, down.transpose(-2, -1), offs=offs)
    out, start = [], 0
    for e, n in enumerate(counts.tolist()):
        r = rows[start:start + n]
        gu = r @ gate_up[e].t()
        out.append((F.silu(gu[:, :width]) * gu[:, width:]) @ down[e].t())
        start += n
    return torch.cat(out)


class Experts(nn.Module):
    """The routed experts' weights, stacked: ``gate_up_proj [E, 2I, H]``
    (each expert's gate rows, then its up rows) and ``down_proj [E, H,
    I]``, stored in ``param_dtype`` and cast to the compute dtype at the
    call."""

    def __init__(self, c: DeepseekV2TextConfig, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        e, h, i = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        store = param_dtype or dtype
        self.gate_up_proj = nn.Parameter(torch.empty(e, 2 * i, h, dtype=store))
        self.down_proj = nn.Parameter(torch.empty(e, h, i, dtype=store))

    def forward(self, rows: torch.Tensor, counts: torch.Tensor
                ) -> torch.Tensor:
        return grouped_products(rows.to(self.dtype), counts,
                                self.gate_up_proj.to(self.dtype),
                                self.down_proj.to(self.dtype))


class MoE(nn.Module):
    """Routed experts plus shared experts. ``expert_rows``: the per-expert
    row counts of the last call (a device tensor)."""

    def __init__(self, c: DeepseekV2TextConfig, dtype, param_dtype):
        super().__init__()
        self.c = c
        self.gate = Router(c, dtype, param_dtype)
        self.experts = Experts(c, dtype, param_dtype)
        self.shared_experts = MLP(c.hidden_size,
                                  c.moe_intermediate_size * c.n_shared_experts,
                                  dtype, param_dtype)
        self.expert_rows: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.c.num_experts_per_tok
        flat = x.reshape(-1, x.shape[-1])
        with span("moe_route"):
            weights, experts = self.gate(flat)
            order, counts = dispatch(experts, self.c.n_routed_experts)
            rows = flat[order // k]
        self.expert_rows = counts
        with span("moe_experts"):
            out = self.experts(rows, counts)
            # back to (token, choice) order, then each token's k outputs
            # weighted and summed in one batched product (fp32 sums)
            out = torch.empty_like(out).index_copy_(0, order, out)
            y = torch.bmm(weights.to(out.dtype)[:, None, :],
                          out.view(-1, k, out.shape[-1]))[:, 0]
        with span("text_mlp"):
            y = y + self.shared_experts(flat)
        return y.view(x.shape)


class DecoderLayer(nn.Module):
    def __init__(self, c: DeepseekV2TextConfig, index: int, dtype,
                 param_dtype):
        super().__init__()
        h, eps = c.hidden_size, c.rms_norm_eps
        self.input_layernorm = RMSNorm(h, eps, dtype)
        self.self_attn = LatentAttention(c, dtype, param_dtype)
        self.post_attention_layernorm = RMSNorm(h, eps, dtype)
        self.dense = not (index >= c.first_k_dense_replace
                          and index % c.moe_layer_freq == 0)
        self.mlp = (MLP(h, c.intermediate_size, dtype, param_dtype)
                    if self.dense else MoE(c, dtype, param_dtype))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
        with span("text_attention"):
            x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        h = self.post_attention_layernorm(x)
        if self.dense:
            with span("text_mlp"):
                return x + self.mlp(h)
        return x + self.mlp(h)


class DeepseekV2TextTower(nn.Module):
    """``input_ids [B, T]`` (right-padded; the mask is the pooling's) → the
    final RMSNorm's hidden states ``[B, T, H]``: token embedding, then
    ``layer_0 … layer_{n-1}``, then ``norm``."""

    def __init__(self, cfg: DeepseekV2TextConfig, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, axis=None):
        super().__init__()
        if axis is not None:
            raise ValueError("the DeepSeek-V2 text tower has no tensor "
                             "parallel: run it with mesh.num_model=1")
        check_supported(cfg)
        self.cfg, self.remat = cfg, remat
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, dtype,
                                  param_dtype)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}",
                            DecoderLayer(cfg, i, dtype, param_dtype))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embed_tokens(input_ids)
        cos, sin = rope_table(self.cfg, input_ids.shape[1], input_ids.device)
        for i in range(self.cfg.num_hidden_layers):
            layer = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        return self.norm(x)
