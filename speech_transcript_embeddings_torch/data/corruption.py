# The port's copy of speech_transcript_embeddings_tpu/data/corruption.py: the port imports
# nothing of the JAX package. Keep the two in step.
"""Corrupted-transcript hard-negative generation.

Behavioral parity with the reference's ``create_corrupted_transcript``
(trainer_unfreeze.py:784-829): five strategies (replace / shuffle / drop / add /
partial) over whitespace tokens, with the same Portuguese filler vocabularies.
Differences by design (SURVEY.md §7 "quirks to fix"):
  * seeded ``numpy.random.Generator`` instead of process-global ``random`` —
    corruption is reproducible and re-randomised per epoch by reseeding,
  * ``corruption_probability`` is honoured (the reference stored it but corrupted
    every sample unconditionally — trainer_unfreeze.py:769-770); the reference's
    actual behavior is recovered with probability=1.0, which is the default.
"""

from __future__ import annotations

import numpy as np

REPLACE_WORDS = (
    "sim", "não", "e", "o", "de", "um", "uma", "tua", "qualquer", "coisa",
    "deveria", "gostaria", "imaginemos",
)
ADD_WORDS = ("sim", "não", "e", "o", "de", "um", "uma")
STRATEGIES = ("replace", "shuffle", "drop", "add", "partial")


def create_corrupted_transcript(text: str, rng: np.random.Generator,
                                probability: float = 1.0) -> str:
    """Return a corrupted copy of ``text`` (or ``text`` itself for 1-word inputs
    or when the corruption coin-flip fails)."""
    words = text.split()
    if len(words) <= 1:
        return text
    if probability < 1.0 and rng.random() >= probability:
        return text

    strategy = STRATEGIES[rng.integers(len(STRATEGIES))]
    if strategy == "replace":
        idx = int(rng.integers(len(words)))
        words[idx] = REPLACE_WORDS[rng.integers(len(REPLACE_WORDS))]
    elif strategy == "shuffle":
        if len(words) > 2:
            start = int(rng.integers(0, len(words) - 1))
            end = int(rng.integers(start + 1, len(words)))
            seg = words[start:end + 1]
            rng.shuffle(seg)
            words[start:end + 1] = seg
    elif strategy == "drop":
        words.pop(int(rng.integers(len(words))))
    elif strategy == "add":
        idx = int(rng.integers(len(words) + 1))
        words.insert(idx, ADD_WORDS[rng.integers(len(ADD_WORDS))])
    elif strategy == "partial":
        if rng.random() < 0.5:
            words = words[: len(words) // 2]
        else:
            words = words[len(words) // 2:]
    return " ".join(words)
