# The port's copy of speech_transcript_embeddings_tpu/data/tokenizers.py: the port imports
# nothing of the JAX package. Keep the two in step.
"""Text tokenisation for the pipeline.

Production path wraps a HuggingFace tokenizer (the reference tokenises with
``AutoTokenizer`` from the text model — trainer_unfreeze.py:840-853, RoBERTa-style
specials and ``max_length`` padding). For offline / synthetic runs and tests a small
deterministic word tokenizer provides the same interface and special-token layout
(bos 0, pad 1, eos 2, unk 3 — the XLM-R convention).
"""

from __future__ import annotations

import hashlib
from typing import Protocol, Tuple

import numpy as np


class Tokenizer(Protocol):
    pad_token_id: int

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """→ (input_ids [max_length] int32, attention_mask [max_length] int32)."""
        ...


class SimpleWordTokenizer:
    """Deterministic hash-based word tokenizer (offline stand-in).

    Stable across processes (hashlib, not ``hash``). Words map into
    [num_special, vocab_size); collisions are acceptable for synthetic data.
    """

    bos_token_id = 0
    pad_token_id = 1
    eos_token_id = 2
    unk_token_id = 3
    num_special = 4

    def __init__(self, vocab_size: int = 1024):
        self.vocab_size = vocab_size

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.sha1(word.lower().encode()).digest()[:4], "little")
        return self.num_special + h % (self.vocab_size - self.num_special)

    def encode(self, text: str, max_length: int):
        ids = [self.bos_token_id]
        ids += [self._word_id(w) for w in text.split()][: max_length - 2]
        ids.append(self.eos_token_id)
        out = np.full(max_length, self.pad_token_id, np.int32)
        mask = np.zeros(max_length, np.int32)
        out[: len(ids)] = ids
        mask[: len(ids)] = 1
        return out, mask


class HFTokenizer:
    """Wraps a HuggingFace fast tokenizer (padding='max_length', truncation)."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer
        self.name = name_or_path
        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.pad_token_id = self._tok.pad_token_id
        # full table incl. added tokens — ids are in [0, vocab_size)
        self.vocab_size = len(self._tok)

    def encode(self, text: str, max_length: int):
        enc = self._tok(text, max_length=max_length, padding="max_length",
                        truncation=True, return_tensors="np")
        return (enc["input_ids"][0].astype(np.int32),
                enc["attention_mask"][0].astype(np.int32))


def resolve_tokenizer(cfg, context: str = "run"):
    """Resolve ``cfg.data.tokenizer`` into a Tokenizer instance.

    The reference always tokenizes with the text model's own tokenizer
    (trainer_unfreeze.py:1387, processor.py:33, inherited by both inference
    scripts through ``AudioTextProcessor``); the TPU framework carries that
    identity in the config — which is stored in every checkpoint's
    metadata.json, so training, inference and serving all resolve the SAME
    tokenizer through this one function.

    Rules (see DataConfig.tokenizer):
      * synthetic data → hash tokenizer, always (generated pseudo-word text).
      * 'hash' → the deterministic offline SimpleWordTokenizer.
      * None → hash for 'local' (the offline path); ERROR for 'common_voice' —
        real text silently tokenized with the wrong vocab poisons training and
        makes real-data inference produce garbage embeddings with no error.
      * anything else → HF tokenizer, with a vocab-vs-embedding-table check
        (token ids must index inside model.text.vocab_size).
    """
    spec = cfg.data.tokenizer
    if cfg.data.dataset == "synthetic" or spec == "hash":
        return SimpleWordTokenizer(vocab_size=cfg.model.text.vocab_size)
    if spec in (None, ""):
        if cfg.data.dataset == "common_voice":
            raise ValueError(
                f"data.tokenizer is not set for a common_voice {context}. Real "
                "text must be tokenized with the text encoder's own tokenizer "
                "(the reference uses AutoTokenizer.from_pretrained(text_model) "
                "— trainer_unfreeze.py:1387). Set data.tokenizer to the HF "
                "tokenizer name (the flagship/retrieval presets default to "
                "paraphrase-multilingual-mpnet-base-v2, flagship-roberta to "
                "all-roberta-large-v1), or 'hash' to explicitly opt into the "
                "offline hash tokenizer.")
        return SimpleWordTokenizer(vocab_size=cfg.model.text.vocab_size)
    tok = HFTokenizer(spec)
    if tok.vocab_size > cfg.model.text.vocab_size:
        raise ValueError(
            f"Tokenizer {spec!r} has vocab_size {tok.vocab_size} but "
            f"model.text.vocab_size is {cfg.model.text.vocab_size}: its token "
            "ids would index out of range of the text embedding table. Use the "
            "text encoder's own tokenizer (e.g. preset=flagship-roberta pairs "
            "the 50265-vocab roberta tokenizer with the 50265-row encoder).")
    return tok
