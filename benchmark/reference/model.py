"""The plain reference of the dual encoder: log-mel frontend, w2v-bert-2.0
conformer with the Shaw relative_key bias, XLM-R text encoder, attentive
pooling and projection heads, the cross-modal fusion and word-alignment
heads, the two contrastive losses and the AdamW update with
discriminative learning rates.

Plain PyTorch, written from the layer equations and a configuration's
widths (``configs/<name>.json``, its ``model`` group). It imports nothing of
the program: it reads a dict of weights by name (``param_specs`` lists
them) and the inputs the benchmark made. Every product runs in fp32 with
TF32 off, the frontend in float64; dropout and SpecAugment are not here
(the configurations that train switch them off). ``precision="fp8"``
computes as float8 training does, the control that a lower precision than
the configuration states is caught: both operands of every product rounded
to e4m3 and the gradients flowing back through them to e5m2, each with a
per-tensor scale to the format's largest value.

Memory: each encoder block runs under ``torch.utils.checkpoint`` when
gradients are on, so a training step at the cells' sizes holds one block's
scores at a time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0          # the largest float8 e4m3 value
FP8_GRAD_MAX = 57344.0   # the largest float8 e5m2 value
NEG_HEAD = -1e9          # the heads' masked score


# ---- precision --------------------------------------------------------------

class _Fp8(torch.autograd.Function):
    """float8 training's rounding of a product's operand: e4m3 forward, the
    gradient that flows back through it e5m2, each with a per-tensor scale
    to the format's largest value."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_GRAD_MAX)


def _round(x, dtype, largest):
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = largest / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class Precision:
    """How the reference rounds the operands of its products."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kind == "fp32" else _Fp8.apply(x)

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b

    def einsum(self, spec, a, b):
        return torch.einsum(spec, self.q(a), self.q(b))


# ---- parameters -------------------------------------------------------------

def _dense(out: Dict, name: str, i: int, o: int, bias: bool = True) -> None:
    out[f"{name}.weight"] = ((o, i), "dense")
    if bias:
        out[f"{name}.bias"] = ((o,), "bias")


def _norm(out: Dict, name: str, d: int) -> None:
    out[f"{name}.weight"] = ((d,), "norm_scale")
    out[f"{name}.bias"] = ((d,), "bias")


def _projection(out, name, i, d, hidden):
    _dense(out, f"{name}.dense_in", i, hidden)
    _dense(out, f"{name}.dense_out", hidden, d)
    _norm(out, f"{name}.norm", d)


def param_specs(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every weight of the model of ``m`` (a configuration's ``model``
    group): name → (shape, kind), kind one of ``dense`` (``[out, in]``),
    ``bias``, ``norm_scale``, ``embed``, ``distance``, ``depthwise``."""
    t, a, h = m["text"], m["audio"], m["heads"]
    d = h["projection_dim"]
    hidden = h.get("projection_hidden_dim") or 2 * d
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    th, ti = t["hidden_size"], t["intermediate_size"]
    e = "text_encoder.embeddings"
    out[f"{e}.word_embeddings.weight"] = ((t["vocab_size"], th), "embed")
    out[f"{e}.position_embeddings.weight"] = (
        (t["max_position_embeddings"], th), "embed")
    out[f"{e}.token_type_embeddings.weight"] = (
        (t["type_vocab_size"], th), "embed")
    _norm(out, f"{e}.norm", th)
    for i in range(t["num_layers"]):
        p = f"text_encoder.layer_{i}"
        for n in ("query", "key", "value", "out"):
            _dense(out, f"{p}.attention.{n}", th, th)
        _norm(out, f"{p}.attention.norm", th)
        _dense(out, f"{p}.intermediate", th, ti)
        _dense(out, f"{p}.output", ti, th)
        _norm(out, f"{p}.norm", th)
    ah, ai, fd = a["hidden_size"], a["intermediate_size"], a["feature_dim"]
    _norm(out, "audio_encoder.feature_norm", fd)
    _dense(out, "audio_encoder.feature_projection", fd, ah)
    if a["apply_spec_augment"] and a["mask_time_prob"] > 0:
        raise ValueError("the reference has no SpecAugment: switch it off")
    num_pos = a["left_max_rel_pos"] + a["right_max_rel_pos"] + 1
    for i in range(a["num_layers"]):
        p = f"audio_encoder.layer_{i}"
        for ffn in ("ffn1", "ffn2"):
            _norm(out, f"{p}.{ffn}_norm", ah)
            _dense(out, f"{p}.{ffn}.intermediate", ah, ai)
            _dense(out, f"{p}.{ffn}.output", ai, ah)
        _norm(out, f"{p}.attention_norm", ah)
        for n in ("query", "key", "value", "out"):
            _dense(out, f"{p}.attention.{n}", ah, ah)
        out[f"{p}.attention.distance_embedding"] = (
            (num_pos, ah // a["num_heads"]), "distance")
        _norm(out, f"{p}.conv.norm", ah)
        _dense(out, f"{p}.conv.pointwise1", ah, 2 * ah, bias=False)
        out[f"{p}.conv.depthwise_kernel"] = (
            (ah, 1, a["conv_kernel_size"]), "depthwise")
        _norm(out, f"{p}.conv.depthwise_norm", ah)
        _dense(out, f"{p}.conv.pointwise2", ah, ah, bias=False)
        _norm(out, f"{p}.final_norm", ah)
    _projection(out, "text_projection", th, d, hidden)
    _projection(out, "audio_projection", ah, d, hidden)
    if h["use_attentive_pooling"]:
        for name, width in (("text_pooling", th), ("audio_pooling", ah)):
            _dense(out, f"{name}.score_in", width, width // 2)
            _dense(out, f"{name}.score_out", width // 2, 1)
    if h["use_cross_modal"]:
        _dense(out, "text_seq_to_projection", th, d)
        _dense(out, "audio_seq_to_projection", ah, d)
        for name in ("text_to_audio_attention", "audio_to_text_attention"):
            for n in ("query", "key", "value", "out"):
                _dense(out, f"{name}.{n}", d, d)
        for side in ("text", "audio"):
            _dense(out, f"{side}_fusion", 2 * d, d)
            _norm(out, f"{side}_fusion_norm", d)
    if h["use_word_alignment"]:
        w = "word_level_alignment"
        _dense(out, f"{w}.text_proj", th, d)
        _dense(out, f"{w}.audio_proj", ah, d)
        for n in ("attn_q", "attn_k", "attn_v", "attn_out", "output_proj"):
            _dense(out, f"{w}.{n}", d, d)
        _norm(out, f"{w}.norm", d)
        _dense(out, f"{w}.confidence_in", d, d // 2)
        _dense(out, f"{w}.confidence_out", d // 2, 1)
    return out


def trainable_names(m: dict, freeze: dict) -> List[str]:
    """The weights a partial unfreeze trains: the top blocks of each
    encoder, the text embeddings and the audio feature projection where
    the configuration trains them, and every head."""
    if freeze["mode"] != "partial":
        raise ValueError("the reference follows the partial unfreeze only")
    out = []
    for name in param_specs(m):
        parts = name.split(".")
        if parts[0] not in ("text_encoder", "audio_encoder"):
            out.append(name)
            continue
        text = parts[0] == "text_encoder"
        enc = m["text"] if text else m["audio"]
        keep = freeze["text_layers_to_unfreeze" if text
                      else "audio_layers_to_unfreeze"]
        if parts[1].startswith("layer_"):
            if int(parts[1][len("layer_"):]) >= enc["num_layers"] - keep:
                out.append(name)
        elif freeze["train_text_embeddings" if text
                    else "train_audio_feature_projection"]:
            out.append(name)
    return out


def lr_scale(name: str, freeze: dict, optimizer: dict) -> float:
    """The discriminative factor of a trainable weight's learning rate."""
    if name.split(".")[0] in ("text_encoder", "audio_encoder"):
        return 1.0 / optimizer["encoder_lr_divisor"]
    return 1.0


# ---- frontend ---------------------------------------------------------------

def _mel_filters(fe: dict) -> np.ndarray:
    """The kaldi-scale triangular mel bank ``[fft//2 + 1, mels]``."""
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)
    num_freq = fe["fft_length"] // 2 + 1
    edges = np.linspace(mel(fe["min_frequency"]), mel(fe["max_frequency"]),
                        fe["num_mel_bins"] + 2)
    bins = mel(fe["sampling_rate"] / fe["fft_length"] * np.arange(num_freq))
    lower, centre, upper = edges[:-2], edges[1:-1], edges[2:]
    rise = (bins[:, None] - lower) / (centre - lower)
    fall = (upper - bins[:, None]) / (upper - centre)
    return np.maximum(0.0, np.minimum(rise, fall))


def log_mel_features(fe: dict, wave: torch.Tensor, num_samples: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waveforms ``[B, N]`` and valid counts ``[B]`` → stacked features
    ``[B, T, mels·stride]`` (fp32) and their mask ``[B, T]``, in float64:
    scale by 2^15, 25 ms frames every 10 ms (frames past the waveform read
    zeros, the count rounded up to the stride), remove the frame's mean,
    preemphasis, Povey window, 512-point real FFT, power, mel, natural log
    over the floor, per-clip per-bin normalisation over the valid frames
    (ddof 1), stacking of ``stride`` frames; a stacked frame is valid where
    its last frame is."""
    n_len, hop, nfft = fe["frame_length"], fe["hop_length"], fe["fft_length"]
    stride, mels = fe["stride"], fe["num_mel_bins"]
    b, n = wave.shape
    frames = 1 + (n - n_len) // hop
    frames = -(-frames // stride) * stride
    need = (frames - 1) * hop + n_len
    x = F.pad(wave.double() * 2.0 ** 15, (0, max(need - n, 0)))
    x = x.unfold(1, n_len, hop)[:, :frames]                 # [B, F, 400]
    x = x - x.mean(-1, keepdim=True)
    p = fe["preemphasis"]
    x = torch.cat([x[..., :1] * (1 - p), x[..., 1:] - p * x[..., :-1]], -1)
    window = torch.from_numpy(np.hanning(n_len) ** 0.85).to(x)
    spec = torch.fft.rfft(x * window, n=nfft)
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.from_numpy(_mel_filters(fe)).to(x)
    logmel = torch.log(torch.clamp(power @ mel, min=fe["mel_floor"]))
    valid = torch.where(num_samples >= n_len,
                        1 + torch.div(num_samples - n_len, hop,
                                      rounding_mode="floor"),
                        torch.zeros_like(num_samples)).to(x.device)
    fmask = (torch.arange(frames, device=x.device)[None] < valid[:, None])
    if fe["per_bin_normalize"]:
        m = fmask[..., None].double()
        count = valid.double().clamp(min=1.0)[:, None, None]
        mean = (logmel * m).sum(1, keepdim=True) / count
        centred = (logmel - mean) * m
        var = (centred * centred).sum(1, keepdim=True) / (count - 1).clamp(
            min=1.0)
        logmel = centred / torch.sqrt(var + 1e-7)
    else:
        logmel = logmel * fmask[..., None]
    feats = logmel.reshape(b, frames // stride, mels * stride)
    mask = fmask.reshape(b, frames // stride, stride)[..., -1]
    return feats.float(), mask


# ---- layers -----------------------------------------------------------------

class Reference:
    """The model of a configuration's ``model`` group over the weights
    ``w`` (name → fp32 tensor)."""

    def __init__(self, m: dict, w: Dict[str, torch.Tensor],
                 precision: str = "fp32"):
        self.m, self.w = m, w
        self.p = Precision(precision)

    def dense(self, name, x):
        return self.p.linear(x, self.w[f"{name}.weight"],
                             self.w.get(f"{name}.bias"))

    def norm(self, name, x, eps=1e-5):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], eps)

    def _softmax_av(self, scores, mask, fill, v):
        """Masked softmax over the keys (``mask [B, Tk]``, 0 masked, the
        score set to ``fill``), then the product with ``v [B, Tk, h, hd]``
        → ``[B, Tq, h, hd]``."""
        scores = scores.masked_fill(~mask[:, None, None, :].bool(), fill)
        probs = torch.softmax(scores, dim=-1)
        return self.p.einsum("bhqk,bkhd->bqhd", probs, v)

    # -- audio
    def conformer_block(self, i, x, mask):
        a, p = self.m["audio"], f"audio_encoder.layer_{i}"
        swish = lambda z: z * torch.sigmoid(z)
        ffn = lambda n, z: self.dense(f"{p}.{n}.output", swish(
            self.dense(f"{p}.{n}.intermediate", z)))
        x = x + 0.5 * ffn("ffn1", self.norm(f"{p}.ffn1_norm", x,
                                            a["layer_norm_eps"]))
        h = self.norm(f"{p}.attention_norm", x, a["layer_norm_eps"])
        b, t, width = h.shape
        nh = a["num_heads"]
        hd = width // nh
        q, k, v = (self.dense(f"{p}.attention.{n}", h).reshape(b, t, nh, hd)
                   for n in ("query", "key", "value"))
        pos = torch.arange(t, device=x.device)
        dist = torch.clamp(pos[None, :] - pos[:, None], -a["left_max_rel_pos"],
                           a["right_max_rel_pos"]) + a["left_max_rel_pos"]
        table = self.w[f"{p}.attention.distance_embedding"]
        qe = self.p.einsum("bqhd,pd->bhqp", q, table)         # [B, h, T, P]
        rel = torch.gather(qe, 3, dist[None, None].expand(b, nh, t, t))
        scores = (self.p.einsum("bqhd,bkhd->bhqk", q, k) + rel) / math.sqrt(hd)
        att = self._softmax_av(scores, mask, torch.finfo(torch.float32).min,
                               v)
        x = x + self.dense(f"{p}.attention.out", att.reshape(b, t, width))
        h = self.norm(f"{p}.conv.norm", x, a["layer_norm_eps"])
        h = h * mask[..., None]
        ag = self.dense(f"{p}.conv.pointwise1", h)
        h = ag[..., :width] * torch.sigmoid(ag[..., width:])
        kernel = self.w[f"{p}.conv.depthwise_kernel"]
        h = F.conv1d(F.pad(self.p.q(h).transpose(1, 2),
                           (kernel.shape[-1] - 1, 0)),
                     self.p.q(kernel), groups=width).transpose(1, 2)
        h = swish(self.norm(f"{p}.conv.depthwise_norm", h,
                            a["layer_norm_eps"]))
        x = x + self.dense(f"{p}.conv.pointwise2", h)
        x = x + 0.5 * ffn("ffn2", self.norm(f"{p}.ffn2_norm", x,
                                            a["layer_norm_eps"]))
        return self.norm(f"{p}.final_norm", x, a["layer_norm_eps"])

    def audio_hidden(self, feats, mask):
        a = self.m["audio"]
        mask = mask.float()
        x = self.dense("audio_encoder.feature_projection", self.norm(
            "audio_encoder.feature_norm", feats, a["layer_norm_eps"]))
        x = x * mask[..., None]
        for i in range(a["num_layers"]):
            x = self._block(self.conformer_block, i, x, mask)
        return x

    # -- text
    def text_layer(self, i, x, mask):
        t, p = self.m["text"], f"text_encoder.layer_{i}"
        b, n, width = x.shape
        nh = t["num_heads"]
        hd = width // nh
        q, k, v = (self.dense(f"{p}.attention.{c}", x).reshape(b, n, nh, hd)
                   for c in ("query", "key", "value"))
        scores = self.p.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = self._softmax_av(scores, mask, torch.finfo(torch.float32).min,
                               v)
        x = self.norm(f"{p}.attention.norm", x + self.dense(
            f"{p}.attention.out", att.reshape(b, n, width)),
            t["layer_norm_eps"])
        y = self.dense(f"{p}.output", F.gelu(self.dense(
            f"{p}.intermediate", x)))
        return self.norm(f"{p}.norm", x + y, t["layer_norm_eps"])

    def text_hidden(self, ids, mask):
        t, e = self.m["text"], "text_encoder.embeddings"
        keep = (ids != t["pad_token_id"]).long()
        pos = torch.cumsum(keep, 1) * keep + t["pad_token_id"]
        x = (self.w[f"{e}.word_embeddings.weight"][ids]
             + self.w[f"{e}.position_embeddings.weight"][pos]
             + self.w[f"{e}.token_type_embeddings.weight"][
                 torch.zeros_like(ids)])
        x = self.norm(f"{e}.norm", x, t["layer_norm_eps"])
        mask = mask.float()
        for i in range(t["num_layers"]):
            x = self._block(self.text_layer, i, x, mask)
        return x

    def _block(self, fn, i, x, mask):
        if torch.is_grad_enabled() and x.requires_grad:
            return checkpoint(fn, i, x, mask, use_reentrant=False)
        return fn(i, x, mask)

    # -- heads
    def pool(self, name, hidden, mask):
        if not self.m["heads"]["use_attentive_pooling"]:
            return hidden[:, 0]
        s = self.dense(f"{name}.score_out", torch.tanh(
            self.dense(f"{name}.score_in", hidden)))[..., 0]
        s = s.masked_fill(~mask.bool(), NEG_HEAD)
        return torch.einsum("bt,bth->bh", torch.softmax(s, -1), hidden)

    def project(self, name, x):
        x = F.gelu(self.dense(f"{name}.dense_in", x))
        return self.norm(f"{name}.norm", self.dense(f"{name}.dense_out", x))

    def cross_attention(self, name, x, ctx, mask):
        heads = self.m["heads"]["cross_modal_heads"]
        b, n, d = ctx.shape
        hd = d // heads
        q = self.dense(f"{name}.query", x).reshape(b, 1, heads, hd)
        k = self.dense(f"{name}.key", ctx).reshape(b, n, heads, hd)
        v = self.dense(f"{name}.value", ctx).reshape(b, n, heads, hd)
        scores = self.p.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        out = self._softmax_av(scores, mask, NEG_HEAD, v)
        return self.dense(f"{name}.out", out.reshape(b, d))

    def fuse(self, text, text_hidden, tmask, audio, audio_hidden, amask):
        audio_seq = self.dense("audio_seq_to_projection", audio_hidden)
        text_seq = self.dense("text_seq_to_projection", text_hidden)
        ta = self.cross_attention("text_to_audio_attention", text, audio_seq,
                                  amask)
        at = self.cross_attention("audio_to_text_attention", audio, text_seq,
                                  tmask)
        text = self.norm("text_fusion_norm", self.dense(
            "text_fusion", torch.cat([text, ta], -1)))
        audio = self.norm("audio_fusion_norm", self.dense(
            "audio_fusion", torch.cat([audio, at], -1)))
        return text, audio

    def alignment_scores(self, text_hidden, audio_hidden, tmask, amask):
        w, heads = "word_level_alignment", self.m["heads"]["alignment_heads"]
        tp = self.dense(f"{w}.text_proj", text_hidden)
        ap = self.dense(f"{w}.audio_proj", audio_hidden)
        b, n, d = tp.shape
        hd = d // heads
        q = self.dense(f"{w}.attn_q", tp).reshape(b, n, heads, hd)
        k = self.dense(f"{w}.attn_k", ap).reshape(b, -1, heads, hd)
        v = self.dense(f"{w}.attn_v", ap).reshape(b, -1, heads, hd)
        scores = self.p.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = self.dense(f"{w}.attn_out", self._softmax_av(
            scores, amask, NEG_HEAD, v).reshape(b, n, d))
        residual = text_hidden if text_hidden.shape[-1] == d else tp
        aligned = self.norm(f"{w}.norm", residual + self.dense(
            f"{w}.output_proj", att))
        conf = F.relu(self.dense(f"{w}.confidence_in", aligned))
        return self.dense(f"{w}.confidence_out", conf)[..., 0] * tmask

    # -- the model's outputs
    def embed_audio(self, wave, num_samples):
        """The serving embedding of each clip: ``[B, D]``, L2-normalised."""
        feats, mask = log_mel_features(self.m["frontend"], wave, num_samples)
        hidden = self.audio_hidden(feats, mask)
        x = self.project("audio_projection",
                         self.pool("audio_pooling", hidden, mask.float()))
        return l2_normalize(x)

    def pos_neg(self, batch):
        """The training forward of one batch (clean and corrupted
        transcript of each clip) → (text_pos, text_neg, audio, alignment
        scores or None), the embeddings L2-normalised."""
        h = self.m["heads"]
        feats, amask = log_mel_features(self.m["frontend"], batch["waveform"],
                                        batch["num_samples"])
        amask = amask.float()
        ids = torch.cat([batch["input_ids_pos"], batch["input_ids_neg"]])
        tmask = torch.cat([batch["attention_mask_pos"],
                           batch["attention_mask_neg"]]).float()
        b = batch["input_ids_pos"].shape[0]
        th = self.text_hidden(ids, tmask)
        text = self.project("text_projection",
                            self.pool("text_pooling", th, tmask))
        ah = self.audio_hidden(feats, amask)
        audio = self.project("audio_projection",
                             self.pool("audio_pooling", ah, amask))
        if h["use_cross_modal"]:
            text, audio2 = self.fuse(text, th, tmask, torch.cat([audio] * 2),
                                     torch.cat([ah] * 2),
                                     torch.cat([amask] * 2))
            audio = audio2[:b]
        scores = None
        if h["use_word_alignment"]:
            scores = self.alignment_scores(th[:b], ah, tmask[:b], amask)
        return (l2_normalize(text[:b]), l2_normalize(text[b:]),
                l2_normalize(audio), scores)


def l2_normalize(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def loss(cfg: dict, text_pos, text_neg, audio, scores):
    """The configuration's contrastive loss: ``global`` (each clip against
    every clean and corrupted transcript of the batch) or ``pairwise``
    (its own two), each sample weighted by the alignment factor where the
    word-alignment head runs, plus the corrupt penalty."""
    tau = cfg["temperature"]
    s_neg = (audio * text_neg).sum(-1)
    if cfg["kind"] == "global":
        logits = audio @ torch.cat([text_pos, text_neg]).t() / tau
        idx = torch.arange(audio.shape[0], device=audio.device)
        per = -F.log_softmax(logits, -1)[idx, idx]
    elif cfg["kind"] == "pairwise":
        s_pos = (audio * text_pos).sum(-1)
        per = -F.log_softmax(torch.stack([s_pos, s_neg], 1) / tau, 1)[:, 0]
    else:
        raise ValueError(f"unknown loss {cfg['kind']!r}")
    if scores is not None:
        per = per * (1.0 - torch.sigmoid(scores.mean(1))
                     * cfg["alignment_weight"])
    return per.mean() + cfg["corrupt_gamma"] * F.relu(s_neg).mean()


class AdamW:
    """AdamW after a clip of the global norm, fp32 moments, with a linear
    warmup then linear decay of the learning rate and a discriminative
    factor per weight; the rate of update ``n`` (from 0) is the schedule at
    ``n``."""

    def __init__(self, optimizer: dict, freeze: dict, total_steps: int,
                 params: Dict[str, torch.Tensor]):
        self.c, self.total = optimizer, total_steps
        self.params = params
        self.scale = {k: lr_scale(k, freeze, optimizer) for k in params}
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    def factor(self, step: int) -> float:
        warm = self.c["warmup_steps"]
        if step < warm:
            return step / max(warm, 1)
        return max((self.total - step) / max(self.total - warm, 1), 0.0)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update of ``params`` from their gradients."""
        c = self.c
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = min(1.0, c["max_grad_norm"] / float(norm)) \
            if float(norm) >= c["max_grad_norm"] else 1.0
        n = self.count + 1
        bc1, bc2 = 1 - c["b1"] ** n, 1 - c["b2"] ** n
        lr = c["learning_rate"] * self.factor(self.count)
        for k, p in self.params.items():
            g = grads[k] * clip
            self.mu[k] = (1 - c["b1"]) * g + c["b1"] * self.mu[k]
            self.nu[k] = (1 - c["b2"]) * g * g + c["b2"] * self.nu[k]
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                        + c["eps"])
            p.sub_(lr * self.scale[k] * (upd + c["weight_decay"] * p))
        self.count = n
