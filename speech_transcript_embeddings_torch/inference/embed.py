"""Batched embedding + cosine-similarity inference API.

Port of ``speech_transcript_embeddings_tpu/inference/embed.py``: an
``Embedder`` over a ``DualEncoderModel`` and its log-mel frontend, with the
JAX API — ``embed_texts``, ``embed_audios``, ``embed_pair`` and
``similarity`` — plus a vectorised ``retrieval_metrics``. Requests keep the
JAX package's shapes: rows padded to a power of two, and audio padded to
one of the configured buckets after peak normalisation, so the kernels see
only those lengths.
"""

from __future__ import annotations

import bisect
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from speech_transcript_embeddings_torch.config import ExperimentConfig
from speech_transcript_embeddings_tpu.data.tokenizers import (
    Tokenizer, resolve_tokenizer,
)
from speech_transcript_embeddings_torch import checkpoints as ckpt_lib
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel, l2_normalize,
)
from speech_transcript_embeddings_torch.ops import make_frontend


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a usable card raises
    (there is no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is "
                           "available")
    return device


class Embedder:
    def __init__(self, cfg: ExperimentConfig, model: DualEncoderModel,
                 tokenizer: Optional[Tokenizer] = None):
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.model = model.eval().requires_grad_(False)
        self.frontend = make_frontend(cfg.model.frontend).to(self.device)
        self.tokenizer = tokenizer or resolve_tokenizer(cfg, context="inference")
        if self.device.type == "cuda":
            # fp32 products in full fp32, as the JAX package runs them
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda",
                        tokenizer: Optional[Tokenizer] = None) -> "Embedder":
        cfg, model = ckpt_lib.load_checkpoint(path, resolve_device(device))
        return cls(cfg, model, tokenizer)

    # ---- batching ------------------------------------------------------------

    @staticmethod
    def _row_bucket(n: int) -> int:
        """Pad the batch to a power of two (a small set of shapes)."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _pad_rows(self, *arrays):
        n = len(arrays[0])
        b = self._row_bucket(n)
        if b == n:
            return arrays
        return tuple(np.concatenate([a, np.repeat(a[:1], b - n, axis=0)])
                     for a in arrays)

    def _tokenize(self, texts: Sequence[str]):
        ids, masks = zip(*(self.tokenizer.encode(t, self.cfg.data.max_text_length)
                           for t in texts))
        return np.stack(ids), np.stack(masks)

    def _pad_audio(self, audios: Sequence[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        max_len = self.cfg.data.max_audio_samples
        lens = [min(len(a), max_len) for a in audios]
        buckets = sorted(self.cfg.data.audio_buckets)
        bucket = buckets[min(bisect.bisect_left(buckets, max(lens)),
                             len(buckets) - 1)]
        wav = np.zeros((len(audios), bucket), np.float32)
        for i, a in enumerate(audios):
            a = np.asarray(a, np.float32)[:bucket]
            peak = np.abs(a).max() if len(a) else 0.0
            if peak > 1.0:
                a = a / peak
            wav[i, :len(a)] = a
            lens[i] = min(lens[i], bucket)
        return wav, np.asarray(lens, np.int32)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---- model calls ---------------------------------------------------------

    @torch.inference_mode()
    def _embed_text(self, ids, masks) -> torch.Tensor:
        proj, _ = self.model.encode_text(self._t(ids), self._t(masks))
        return l2_normalize(proj)

    @torch.inference_mode()
    def _embed_audio(self, wav, lens) -> torch.Tensor:
        features, mask = self.frontend(self._t(wav), self._t(lens))
        proj, _ = self.model.encode_audio(features, mask)
        return l2_normalize(proj)

    # ---- public API ----------------------------------------------------------

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        n = len(texts)
        ids, masks = self._pad_rows(*self._tokenize(texts))
        return self._embed_text(ids, masks).cpu().numpy()[:n]

    def embed_audios(self, audios: Sequence[np.ndarray]) -> np.ndarray:
        n = len(audios)
        wav, lens = self._pad_rows(*self._pad_audio(audios))
        return self._embed_audio(wav, lens).cpu().numpy()[:n]

    @torch.inference_mode()
    def embed_pair(self, text: str, audio: np.ndarray
                   ) -> Tuple[float, np.ndarray, np.ndarray]:
        """The model's pair forward (``forward_pair``) → (similarity,
        text_emb, audio_emb)."""
        ids, mask = self._tokenize([text])
        wav, lens = self._pad_audio([audio])
        features, amask = self.frontend(self._t(wav), self._t(lens))
        text_emb, audio_emb = self.model.forward_pair({
            "input_ids": self._t(ids), "attention_mask": self._t(mask),
            "input_features": features, "attention_mask_audio": amask})
        te, ae = text_emb[0].cpu().numpy(), audio_emb[0].cpu().numpy()
        return float(np.sum(te * ae)), te, ae

    @staticmethod
    def similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
        b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
        return np.sum(a * b, axis=-1)


def retrieval_metrics(audio_embs: np.ndarray, text_embs: np.ndarray,
                      ks: Sequence[int] = (1, 5, 10)) -> dict:
    """Speech→text retrieval Recall@K (row i's positive is text i), without
    the per-row sort: the positive's rank is the count of texts scoring
    higher, plus the earlier-indexed ties. The JAX function ranks by
    ``np.argsort``, whose order among ties is unspecified, so the two agree
    wherever no text ties the positive's score."""
    sims = audio_embs @ text_embs.T                       # [N, N]
    pos = np.diagonal(sims)[:, None]
    n = sims.shape[0]
    earlier = np.arange(n)[None, :] < np.arange(n)[:, None]
    ranks = np.sum((sims > pos) | ((sims == pos) & earlier), axis=1)
    out = {f"recall@{k}": float(np.mean(ranks < k)) for k in ks}
    out["mean_rank"] = float(ranks.mean() + 1)
    out["mrr"] = float(np.mean(1.0 / (ranks + 1)))
    return out
