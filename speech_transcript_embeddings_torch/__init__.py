"""speech_transcript_embeddings_torch — the PyTorch/CUDA port of the serving path.

A second package beside ``speech_transcript_embeddings_tpu`` (the JAX reference,
which stays as it is). It serves L2-normalised speech and transcript embeddings
from the dual encoder on an NVIDIA Hopper GPU:

  * ``ops/``       log-mel frontend and relative_key flash attention, each a
                   hand-written CUDA kernel (``csrc/``, built by ``nvcc`` for
                   ``sm_90a`` on first use) beside its plain PyTorch twin,
  * ``models/``    conformer audio encoder, XLM-R text encoder, heads and the
                   dual encoder (eval path),
  * ``bridge.py``  Flax param tree → ``state_dict``,
  * ``checkpoints.py``, ``inference/embed.py`` and ``serve.py``.

The package imports ``torch`` and never ``jax``; it reuses the JAX package's
framework-free modules (config, tokenizers, synthetic audio, the HTTP
micro-batcher and handler) by import.
"""

__version__ = "0.1.0"
