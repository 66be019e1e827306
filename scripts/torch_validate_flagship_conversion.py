#!/usr/bin/env python
"""Flagship-geometry conversion and ingestion, held to HuggingFace's
forward: the port of ``scripts/validate_flagship_conversion.py``.

    python scripts/torch_validate_flagship_conversion.py --device cpu
        [--text-arch xlmr|roberta-large]

Every run of the port from published or reference weights goes through
``models/convert.py`` and ``models/ingest_torch.py``, which the unit tests
exercise only at toy sizes (2-layer, 32-wide oracles). A shape, head-count
or renaming fault that shows only at the real sizes would be caught here:
the script builds HF models at the real flagship geometry with random
weights (constructing ``XLMRobertaConfig`` 12×768 and
``Wav2Vec2BertConfig`` 24×1024 models needs no download; only the
architecture matters for conversion), under the JAX script's
``torch.manual_seed`` values (0 text, 1 audio, 7 heads), so that the max|Δ|
here stand beside JAX's recorded ones, and checks:

1. text: HF XLMRoberta 12×768 (vocab 250,002) → ``text_config_from_hf`` /
   ``convert_text_encoder`` → the port's ``TextEncoder`` against the HF
   forward on a ragged [4, 128] batch, tolerance 1e-3;
2. audio: HF Wav2Vec2Bert 24×1024 (feature dim 160, conv kernel 31,
   relative_key 64/8) → ``audio_config_from_hf`` / ``convert_audio_encoder``
   → the port's ``AudioEncoder`` on a ragged [2, 499] batch (499 frames =
   a 10 s clip), tolerance 2e-3;
3. (JAX's restack involution has no counterpart: the port keeps one
   layout, every layer its own module, so there is nothing to restack);
4. a reference-style checkpoint at flagship dims (the encoders and the
   projection, pooling, cross-modal, sequence-to-projection, alignment
   and fusion heads, proj 768, as the reference trainer saves them) →
   ``sniff_reference_config`` gives the flagship geometry →
   ``state_dict_from_reference_checkpoint`` gives encoder tensors
   bit-equal to the direct conversion → the projection, pooling,
   word-alignment (4 heads) and cross-modal (8 heads) heads held to the
   torch oracle modules at 1e-4 → ``convert_checkpoint --from-torch`` →
   ``Embedder``: unit-norm text and audio embeddings and an ``embed_pair``
   score in [−1, 1];
5. ``build_converted_params`` at flagship dims feeds ``DualEncoderModel``'s
   ``forward_pair``: unit-norm fp32 embeddings.

``--text-arch roberta-large`` switches the text side to the reference's
other text encoder (RobertaModel 24×1024, vocab 50,265, projection 1024).
The port's modules run on ``--device`` (default cuda; cuda without a card
raises); the HF oracles on the host, in fp32. Each check prints a PASS line
with its max|Δ| and tolerance (a FAIL exits non-zero); then one JSON line
of them all, then the all-passed line. Run on the host (``--device cpu``)
it takes some minutes. Recorded outputs:
``runs/torch_flagship_conversion_validation.txt``,
``runs/torch_roberta_conversion_validation.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

# flagship geometry (SURVEY.md §2 "Pretrained encoders": mpnet = XLM-R base
# 12×768, facebook/w2v-bert-2.0 = 24×1024 conformer, projection 768);
# ``set_text_arch("roberta-large")``: sentence-transformers/
# all-roberta-large-v1 (24×1024, vocab 50,265, projection 1024)
D_TEXT, TEXT_LAYERS, TEXT_HEADS = 768, 12, 12
D_AUDIO, AUDIO_LAYERS, AUDIO_HEADS = 1024, 24, 16
D_PROJ = 768
VOCAB = 250002
TEXT_ARCH = "xlmr"
RESULTS: list = []


def set_text_arch(arch: str) -> None:
    global D_TEXT, TEXT_LAYERS, TEXT_HEADS, D_PROJ, VOCAB, TEXT_ARCH
    TEXT_ARCH = arch
    if arch == "roberta-large":
        D_TEXT, TEXT_LAYERS, TEXT_HEADS = 1024, 24, 16
        D_PROJ, VOCAB = 1024, 50265
    elif arch != "xlmr":
        raise SystemExit(f"unknown --text-arch {arch!r}")


def _np(t):
    return t.detach().float().cpu().numpy()


def _report(name: str, got, ref, atol: float) -> float:
    diff = float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(ref, np.float64))))
    ok = diff <= atol
    print(f"{'PASS' if ok else 'FAIL'} {name}: max|Δ|={diff:.3e} "
          f"(tolerance {atol:g})", flush=True)
    RESULTS.append({"check": name, "max_abs_diff": diff, "tolerance": atol})
    if not ok:
        raise SystemExit(f"{name} exceeded tolerance")
    return diff


def _state_equal(name: str, got, want) -> None:
    if set(got) != set(want):
        raise SystemExit(f"{name}: keys differ: "
                         f"{sorted(set(got) ^ set(want))[:8]}")
    for k in want:
        if not torch.equal(got[k], want[k]):
            raise SystemExit(f"{name}: {k} differs")
    print(f"PASS {name}: {len(want)} tensors bit-identical", flush=True)
    RESULTS.append({"check": name, "tensors": len(want)})


def _sub(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def build_text_hf():
    torch.manual_seed(0)
    kwargs = dict(
        vocab_size=VOCAB, hidden_size=D_TEXT, num_hidden_layers=TEXT_LAYERS,
        num_attention_heads=TEXT_HEADS, intermediate_size=4 * D_TEXT,
        max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    if TEXT_ARCH == "roberta-large":
        from transformers import RobertaConfig, RobertaModel
        hf_cfg = RobertaConfig(**kwargs)
        return RobertaModel(hf_cfg, add_pooling_layer=False).eval(), hf_cfg
    from transformers import XLMRobertaConfig, XLMRobertaModel
    hf_cfg = XLMRobertaConfig(**kwargs)
    return XLMRobertaModel(hf_cfg, add_pooling_layer=False).eval(), hf_cfg


def build_audio_hf():
    from transformers import Wav2Vec2BertConfig, Wav2Vec2BertModel
    torch.manual_seed(1)
    hf_cfg = Wav2Vec2BertConfig(
        feature_projection_input_dim=160, hidden_size=D_AUDIO,
        num_hidden_layers=AUDIO_LAYERS, num_attention_heads=AUDIO_HEADS,
        intermediate_size=4 * D_AUDIO, conv_depthwise_kernel_size=31,
        left_max_position_embeddings=64, right_max_position_embeddings=8,
        hidden_dropout=0.0, attention_dropout=0.0, conformer_conv_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
        mask_time_prob=0.0, mask_feature_prob=0.0, apply_spec_augment=False)
    return Wav2Vec2BertModel(hf_cfg).eval(), hf_cfg


def validate_text(hf, hf_cfg, device):
    """→ the direct conversion's state dict."""
    from speech_transcript_embeddings_torch.models import convert
    from speech_transcript_embeddings_torch.models.text_encoder import (
        TextEncoder,
    )
    t0 = time.time()
    cfg = convert.text_config_from_hf(hf_cfg)
    state = convert.convert_text_encoder(hf.state_dict(), cfg)
    with torch.device(device):
        enc = TextEncoder(cfg, torch.float32)
    enc.load_state_dict(state, strict=True)
    enc.eval()
    rng = np.random.default_rng(2)
    b, t = 4, 128
    ids = rng.integers(2, VOCAB, size=(b, t))
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate([128, 97, 55, 12]):
        mask[i, :n] = 1
        ids[i, n:] = 1          # pad token
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(
            mask)).last_hidden_state.numpy()
        got = _np(enc(torch.tensor(ids, device=device),
                      torch.tensor(mask, device=device)))
    valid = mask.astype(bool)
    _report(f"text encoder {TEXT_LAYERS}x{D_TEXT} vs torch", got[valid],
            ref[valid], 1e-3)
    print(f"     (text validation {time.time() - t0:.1f}s)", flush=True)
    return state


def validate_audio(hf, hf_cfg, device):
    """→ the direct conversion's state dict."""
    from speech_transcript_embeddings_torch.models import convert
    from speech_transcript_embeddings_torch.models.audio_encoder import (
        AudioEncoder,
    )
    t0 = time.time()
    cfg = convert.audio_config_from_hf(hf_cfg)
    state = convert.convert_audio_encoder(hf.state_dict(), cfg)
    with torch.device(device):
        enc = AudioEncoder(cfg, torch.float32)
    enc.load_state_dict(state, strict=True)
    enc.eval()
    rng = np.random.default_rng(3)
    b, t = 2, 499               # 499 stacked frames = one 10 s clip
    feats = rng.normal(size=(b, t, 160)).astype(np.float32)
    mask = np.zeros((b, t), np.int32)
    mask[0, :499] = 1
    mask[1, :361] = 1
    with torch.no_grad():
        ref = hf(input_features=torch.tensor(feats),
                 attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
        got = _np(enc(torch.tensor(feats, device=device),
                      torch.tensor(mask, device=device)))
    valid = mask.astype(bool)
    _report(f"audio encoder {AUDIO_LAYERS}x{D_AUDIO} vs torch", got[valid],
            ref[valid], 2e-3)
    print(f"     (audio validation {time.time() - t0:.1f}s)", flush=True)
    return state


# ---- reference-style checkpoint at flagship dims (trainer_unfreeze.py layout)

def _torch_projection(d_in, d_proj):
    m = torch.nn.Module()
    m.projection = torch.nn.Sequential(
        torch.nn.Linear(d_in, 2 * d_proj), torch.nn.GELU(),
        torch.nn.Dropout(0.0), torch.nn.Linear(2 * d_proj, d_proj),
        torch.nn.LayerNorm(d_proj))
    return m


def _torch_pooling(d):
    m = torch.nn.Module()
    m.attention = torch.nn.Sequential(
        torch.nn.Linear(d, d // 2), torch.nn.Tanh(),
        torch.nn.Linear(d // 2, 1))
    return m


class _TorchCrossModal(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.query = torch.nn.Linear(d, d)
        self.key = torch.nn.Linear(d, d)
        self.value = torch.nn.Linear(d, d)
        self.out_proj = torch.nn.Linear(d, d)


class _TorchAlignment(torch.nn.Module):
    def __init__(self, d_text, d_audio, d, heads):
        super().__init__()
        self.text_projection = torch.nn.Linear(d_text, d)
        self.audio_projection = torch.nn.Linear(d_audio, d)
        self.alignment_attention = torch.nn.MultiheadAttention(
            d, heads, dropout=0.0, batch_first=True)
        self.output_projection = torch.nn.Linear(d, d)
        self.layer_norm = torch.nn.LayerNorm(d)
        self.alignment_confidence = torch.nn.Sequential(
            torch.nn.Linear(d, d // 2), torch.nn.ReLU(),
            torch.nn.Linear(d // 2, 1))


def build_reference_ckpt(text_hf, audio_hf):
    torch.manual_seed(7)
    heads = {
        "text_projection": _torch_projection(D_TEXT, D_PROJ),
        "audio_projection": _torch_projection(D_AUDIO, D_PROJ),
        "text_pooling": _torch_pooling(D_TEXT),
        "audio_pooling": _torch_pooling(D_AUDIO),
        "text_to_audio_attention": _TorchCrossModal(D_PROJ),
        "audio_to_text_attention": _TorchCrossModal(D_PROJ),
        "text_seq_to_projection": torch.nn.Linear(D_TEXT, D_PROJ),
        "audio_seq_to_projection": torch.nn.Linear(D_AUDIO, D_PROJ),
        "word_level_alignment": _TorchAlignment(D_TEXT, D_AUDIO, D_PROJ, 4),
        "text_fusion": torch.nn.Sequential(
            torch.nn.Linear(2 * D_PROJ, D_PROJ), torch.nn.LayerNorm(D_PROJ)),
        "audio_fusion": torch.nn.Sequential(
            torch.nn.Linear(2 * D_PROJ, D_PROJ), torch.nn.LayerNorm(D_PROJ)),
    }
    sd = {}
    for name, m in {"text_encoder": text_hf, "audio_encoder": audio_hf,
                    **heads}.items():
        for k, v in m.state_dict().items():
            sd[f"{name}.{k}"] = v
    ckpt = {
        "model_state_dict": sd,
        "epoch": 23, "temperature": 0.1, "projection_dim": D_PROJ,
        "use_cross_modal": True, "use_attentive_pooling": True,
        "use_word_alignment": True,
    }
    return ckpt, heads


def _module(cls, state, prefix, device, *args, **kwargs):
    """``cls(*args, **kwargs)`` on ``device`` holding ``state``'s tensors
    under ``prefix``."""
    with torch.device(device):
        m = cls(*args, **kwargs)
    m.load_state_dict(_sub(state, prefix), strict=True)
    return m.eval()


def validate_ingest(text_hf, audio_hf, text_state, audio_state, workdir,
                    device):
    """→ the ingested state dict."""
    from speech_transcript_embeddings_torch import convert_checkpoint
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    from speech_transcript_embeddings_torch.models import heads as H
    from speech_transcript_embeddings_torch.models import ingest_torch
    t0 = time.time()
    ckpt, heads = build_reference_ckpt(text_hf, audio_hf)

    cfg = ingest_torch.sniff_reference_config(ckpt)
    m = cfg.model
    checks = {
        "text geometry": ((m.text.hidden_size, m.text.num_layers,
                           m.text.num_heads), (D_TEXT, TEXT_LAYERS,
                                               TEXT_HEADS)),
        "audio geometry": ((m.audio.hidden_size, m.audio.num_layers,
                            m.audio.num_heads), (D_AUDIO, AUDIO_LAYERS,
                                                 AUDIO_HEADS)),
        "vocab": (m.text.vocab_size, VOCAB),
        "feature dim": (m.audio.feature_dim, 160),
        "conv kernel": (m.audio.conv_kernel_size, 31),
        "projection": (m.heads.projection_dim, D_PROJ),
        "heads on": ((m.heads.use_cross_modal, m.heads.use_word_alignment),
                     (True, True)),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad:
        raise SystemExit(f"sniffed config at flagship dims: {bad}")
    print("PASS ingest config sniffing at flagship dims", flush=True)
    RESULTS.append({"check": "ingest config sniffing"})

    state = ingest_torch.state_dict_from_reference_checkpoint(ckpt, cfg)
    # encoder tensors must equal the direct conversion (same source weights)
    _state_equal("ingested text encoder == direct conversion",
                 _sub(state, "text_encoder."), text_state)
    _state_equal("ingested audio encoder == direct conversion",
                 _sub(state, "audio_encoder."), audio_state)

    rng = np.random.default_rng(5)
    # projection head
    x = rng.normal(size=(3, D_TEXT)).astype(np.float32)
    proj = _module(H.EnhancedProjection, state, "text_projection.", device,
                   D_TEXT, D_PROJ, 2 * D_PROJ, dropout=0.0)
    with torch.no_grad():
        ours = _np(proj(torch.tensor(x, device=device)))
        ref = heads["text_projection"].projection(torch.from_numpy(x)).numpy()
    _report(f"text projection head {D_TEXT}→{D_PROJ}", ours, ref, 1e-4)

    # attentive pooling (audio side)
    h = rng.normal(size=(2, 33, D_AUDIO)).astype(np.float32)
    mk = np.ones((2, 33), np.int32)
    mk[1, 20:] = 0
    pool = _module(H.AttentivePooling, state, "audio_pooling.", device,
                   D_AUDIO)
    with torch.no_grad():
        pooled = _np(pool(torch.tensor(h, device=device),
                          torch.tensor(mk, device=device)))
        s = heads["audio_pooling"].attention(torch.from_numpy(h)).squeeze(-1)
        s = s.masked_fill(torch.from_numpy(mk) == 0, -1e9)
        w = torch.softmax(s, dim=1)
        ref = (torch.from_numpy(h) * w.unsqueeze(-1)).sum(1).numpy()
    _report(f"audio attentive pooling {D_AUDIO}", pooled, ref, 1e-4)

    # word-level alignment (MultiheadAttention's in_proj split into q, k, v)
    tt = rng.normal(size=(2, 9, D_TEXT)).astype(np.float32)
    aa = rng.normal(size=(2, 17, D_AUDIO)).astype(np.float32)
    align = _module(H.WordLevelAlignment, state, "word_level_alignment.",
                    device, D_TEXT, D_AUDIO, D_PROJ, num_heads=4)
    wa = heads["word_level_alignment"]
    with torch.no_grad():
        aligned, scores_tok, _ = align(torch.tensor(tt, device=device),
                                       torch.tensor(aa, device=device))
        tp = wa.text_projection(torch.from_numpy(tt))
        ap = wa.audio_projection(torch.from_numpy(aa))
        att, _ = wa.alignment_attention(tp, ap, ap)
        # the reference's residual adds the raw text hidden states
        # (trainer_unfreeze.py:299-301): at flagship dims text_hidden ==
        # alignment_dim, the path the reference runs
        ref_aligned = wa.layer_norm(
            torch.from_numpy(tt) + wa.output_projection(att))
        ref_scores = wa.alignment_confidence(ref_aligned).squeeze(-1)
    _report(f"word alignment {D_PROJ} (aligned)", _np(aligned),
            ref_aligned.numpy(), 1e-4)
    _report(f"word alignment {D_PROJ} (scores)", _np(scores_tok),
            ref_scores.numpy(), 1e-4)

    # cross-modal attention at the projection width (the reference's math)
    cm = heads["text_to_audio_attention"]
    q_in = rng.normal(size=(2, 1, D_PROJ)).astype(np.float32)
    ctx = rng.normal(size=(2, 17, D_PROJ)).astype(np.float32)
    cmask = np.ones((2, 17), np.int32)
    cmask[1, 9:] = 0
    nh = 8
    hd = D_PROJ // nh
    cross = _module(H.CrossModalAttention, state, "text_to_audio_attention.",
                    device, D_PROJ, num_heads=nh)
    with torch.no_grad():
        q = cm.query(torch.from_numpy(q_in)).view(2, -1, nh, hd).transpose(
            1, 2)
        k = cm.key(torch.from_numpy(ctx)).view(2, -1, nh, hd).transpose(1, 2)
        v = cm.value(torch.from_numpy(ctx)).view(2, -1, nh, hd).transpose(
            1, 2)
        w = (q @ k.transpose(-2, -1)) * hd ** -0.5
        w = w.masked_fill(torch.from_numpy(cmask)[:, None, None, :] == 0,
                          -1e9)
        w = torch.softmax(w, dim=-1)
        ref = cm.out_proj((w @ v).transpose(1, 2).reshape(
            2, -1, D_PROJ)).numpy()
        got = _np(cross(torch.tensor(q_in, device=device),
                        torch.tensor(ctx, device=device),
                        torch.tensor(cmask, device=device)))
    _report(f"cross-modal attention {D_PROJ}/{nh}h", got, ref, 1e-4)

    # the CLI → Embedder (the serving path's load)
    pt = os.path.join(workdir, "best_model_gap.pt")
    torch.save(ckpt, pt)
    del ckpt
    out = os.path.join(workdir, "ingested_flagship")
    convert_checkpoint.main(["--from-torch", pt, "--output", out])
    os.remove(pt)
    emb = Embedder.from_checkpoint(out, device=device)
    te = emb.embed_texts(["uma frase de validação do pipeline"])
    wav = np.random.default_rng(0).normal(
        scale=0.05, size=32000).astype(np.float32)
    ae = emb.embed_audios([wav])
    fused, _, _ = emb.embed_pair("uma frase de validação", wav)
    norms = np.linalg.norm(np.concatenate([te, ae]).astype(np.float64),
                           axis=1)
    if te.shape != (1, D_PROJ) or ae.shape != (1, D_PROJ) or \
            not np.allclose(norms, 1.0, rtol=1e-4) or \
            not -1.0 <= fused <= 1.0:
        raise SystemExit(f"Embedder at flagship dims: text {te.shape}, "
                         f"audio {ae.shape}, norms {norms}, pair {fused}")
    print(f"PASS torch-ckpt CLI round-trip + Embedder forward at flagship "
          f"dims (norms {norms[0]:.5f}, {norms[1]:.5f} in "
          f"{emb.cfg.model.dtype}; pair {fused:+.4f}; "
          f"{time.time() - t0:.1f}s total)", flush=True)
    RESULTS.append({"check": "CLI round-trip + Embedder",
                    "norms": norms.tolist(), "pair": fused,
                    "dtype": emb.cfg.model.dtype})
    return state


def validate_build_converted(text_hf, audio_hf, device):
    """``build_converted_params``: HF models → the full DualEncoderModel →
    ``forward_pair`` at flagship geometry, fp32."""
    from speech_transcript_embeddings_torch import config as config_lib
    from speech_transcript_embeddings_torch.convert_checkpoint import (
        build_converted_params,
    )
    t0 = time.time()
    cfg, model = build_converted_params(
        text_hf, audio_hf,
        heads_cfg=config_lib.HeadsConfig(projection_dim=D_PROJ),
        dtype="float32", device=device)
    if (cfg.model.text.num_layers, cfg.model.audio.num_layers) != (
            TEXT_LAYERS, AUDIO_LAYERS):
        raise SystemExit(f"build_converted_params: {cfg.model.text}, "
                         f"{cfg.model.audio}")
    rng = np.random.default_rng(11)
    batch = {
        "input_ids": rng.integers(2, VOCAB, size=(2, 16)),
        "attention_mask": np.ones((2, 16), np.int32),
        "input_features": rng.normal(size=(2, 40, 160)).astype(np.float32),
        "attention_mask_audio": np.ones((2, 40), np.int32),
    }
    with torch.no_grad():
        te, ae = model.eval().forward_pair(
            {k: torch.tensor(v, device=device) for k, v in batch.items()})
    norms = np.linalg.norm(_np(te).astype(np.float64), axis=1)
    if te.shape != (2, D_PROJ) or ae.shape != (2, D_PROJ) or \
            te.dtype != torch.float32 or \
            not np.allclose(norms, 1.0, rtol=1e-4):
        raise SystemExit(f"forward_pair at flagship dims: {te.shape} "
                         f"{ae.shape} {te.dtype}, norms {norms}")
    print(f"PASS build_converted_params → forward_pair at flagship dims "
          f"({time.time() - t0:.1f}s)", flush=True)
    RESULTS.append({"check": "build_converted_params → forward_pair",
                    "norms": norms.tolist()})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--text-arch", choices=("xlmr", "roberta-large"),
                    default="xlmr",
                    help="text-encoder geometry: xlmr = mpnet-class 12x768 "
                         "proj 768 (the flagship preset); roberta-large = "
                         "all-roberta-large-v1 24x1024 proj 1024 (the "
                         "reference's other text encoder, model.py:137)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.utils import bench as ub
    device = resolve_device(args.device)
    card = ub.card_line(device.index or 0) if device.type == "cuda" else "cpu"
    print(card, flush=True)
    set_text_arch(args.text_arch)
    RESULTS.clear()
    print(f"flagship conversion validation [{TEXT_ARCH}]: "
          f"text {TEXT_LAYERS}x{D_TEXT} "
          f"(vocab {VOCAB}), audio {AUDIO_LAYERS}x{D_AUDIO}, proj {D_PROJ}",
          flush=True)
    text_hf, text_cfg = build_text_hf()
    audio_hf, audio_cfg = build_audio_hf()
    text_state = validate_text(text_hf, text_cfg, device)
    audio_state = validate_audio(audio_hf, audio_cfg, device)
    with tempfile.TemporaryDirectory() as workdir:
        validate_ingest(text_hf, audio_hf, text_state, audio_state, workdir,
                        device)
    validate_build_converted(text_hf, audio_hf, device)
    out = {"text_arch": TEXT_ARCH, "device": str(device), "card": card,
           "geometry": {"text": [TEXT_LAYERS, D_TEXT, TEXT_HEADS, VOCAB],
                        "audio": [AUDIO_LAYERS, D_AUDIO, AUDIO_HEADS],
                        "projection": D_PROJ},
           "checks": list(RESULTS)}
    print(json.dumps(out), flush=True)
    print("ALL FLAGSHIP-GEOMETRY CONVERSION CHECKS PASSED", flush=True)
    return out


if __name__ == "__main__":
    main()
