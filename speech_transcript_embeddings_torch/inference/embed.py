"""Batched embedding + cosine-similarity inference API.

Port of ``speech_transcript_embeddings_tpu/inference/embed.py``: an
``Embedder`` over a ``DualEncoderModel`` and its log-mel frontend, with the
JAX API — ``embed_texts`` and ``embed_audios`` (independent projection-space
embeddings), ``embed_pair`` and ``pair_similarities`` (the model's pair
forward, cross-modal fusion included when the config fuses) and
``similarity`` — plus a vectorised ``retrieval_metrics``. Requests keep the
JAX package's shapes: rows padded to a power of two, and audio padded to
one of the configured buckets after peak normalisation, so the kernels see
only those lengths. ``quantize_int8`` switches the Dense products of the
pair forward to int8 (W8A8, ``ops/quant.py``).
"""

from __future__ import annotations

import bisect
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from speech_transcript_embeddings_torch.config import ExperimentConfig
from speech_transcript_embeddings_torch.data import Tokenizer, resolve_tokenizer
from speech_transcript_embeddings_torch import checkpoints as ckpt_lib
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel, l2_normalize,
)
from speech_transcript_embeddings_torch.models.layers import Dense
from speech_transcript_embeddings_torch.ops import make_frontend, quant


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
                 tokenizer: Optional[Tokenizer] = None,
                 checkpoint: Optional[str] = None):
        self.cfg = cfg
        self.checkpoint = checkpoint   # its model.pt holds the stored weights
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
        return cls(cfg, model, tokenizer, checkpoint=path)

    # ---- int8 ----------------------------------------------------------------

    def quantize_int8(self) -> "Embedder":
        """Quantize, in place, each Dense that the pair forward calls (as
        JAX's ``dense_param_paths`` traces it: one row, ``max_text_length``
        tokens, the smallest audio bucket), unless ``MIN_QUANT_DIM`` leaves
        it; → self. The weights are quantized as stored (``model.pt`` of the
        checkpoint: fp32 where training kept fp32), not from the serving
        storage, as JAX quantizes the weights it restored. A second call
        finds no Dense left to quantize and changes nothing."""
        called = set()
        dense = {name: m for name, m in self.model.named_modules()
                 if isinstance(m, Dense)}
        hooks = [m.register_forward_hook(
            lambda mod, args, out, name=name: called.add(name))
            for name, m in dense.items()]
        length = self.cfg.data.max_text_length
        bucket = min(self.cfg.data.audio_buckets)
        try:
            self._pair(np.ones((1, length), np.int32),
                       np.ones((1, length), np.int32),
                       np.zeros((1, bucket), np.float32),
                       np.array([bucket], np.int32))
        finally:
            for h in hooks:
                h.remove()
        stored = (ckpt_lib.load_stored_state(self.checkpoint)
                  if self.checkpoint else self.model.state_dict())
        for name in sorted(called):
            mod = dense[name]
            q = quant.quantize_module(
                stored[f"{name}.weight"],
                None if mod.bias is None else stored[f"{name}.bias"],
                mod.dtype, self.device)
            if q is not None:
                parent, _, child = name.rpartition(".")
                setattr(self.model.get_submodule(parent), child, q)
        return self

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

    def _t(self, a) -> torch.Tensor:
        """A host array, or a tensor already placed (a benchmark's
        device-resident batch), on the Embedder's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
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
    def _pair(self, ids, masks, wav, lens) -> Tuple[np.ndarray, np.ndarray]:
        features, amask = self.frontend(self._t(wav), self._t(lens))
        text_emb, audio_emb = self.model.forward_pair({
            "input_ids": self._t(ids), "attention_mask": self._t(masks),
            "input_features": features, "attention_mask_audio": amask})
        return text_emb.cpu().numpy(), audio_emb.cpu().numpy()

    def embed_pair(self, text: str, audio: np.ndarray
                   ) -> Tuple[float, np.ndarray, np.ndarray]:
        """The model's pair forward (``forward_pair``) → (similarity,
        text_emb, audio_emb)."""
        te, ae = self._pair(*self._tokenize([text]), *self._pad_audio([audio]))
        return float(np.sum(te[0] * ae[0])), te[0], ae[0]

    def pair_similarities(self, texts: Sequence[str],
                          audios: Sequence[np.ndarray]) -> np.ndarray:
        """The pair forward's similarity of each (text, audio) pair — the
        score the reference's batch inference writes — in one call per row
        bucket."""
        n = len(texts)
        if n != len(audios):
            raise ValueError(f"{n} texts for {len(audios)} clips")
        te, ae = self._pair(*self._pad_rows(*self._tokenize(texts),
                                            *self._pad_audio(audios)))
        return np.sum(te[:n] * ae[:n], axis=1)

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
