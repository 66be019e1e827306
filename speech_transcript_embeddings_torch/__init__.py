"""speech_transcript_embeddings_torch — the PyTorch/CUDA port of the serving
and training paths.

A second package beside ``speech_transcript_embeddings_tpu`` (the JAX reference,
which stays as it is). It serves and fine-tunes L2-normalised speech and
transcript embeddings from the dual encoder on an NVIDIA Hopper GPU:

  * ``ops/``       log-mel frontend and relative_key flash attention, each a
                   hand-written CUDA kernel (``csrc/``, built by ``nvcc`` for
                   ``sm_90a`` on first use) beside its plain PyTorch twin,
  * ``models/``    conformer audio encoder, XLM-R text encoder, heads and the
                   dual encoder,
  * ``training/``  losses, AdamW, the train step and the epoch loop,
  * ``data/``      bucketed batching, sources and tokenizers,
  * ``bridge.py``  Flax param tree → ``state_dict``,
  * ``checkpoints.py``, ``inference/embed.py``, ``serve.py`` and ``train.py``.

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: the framework-free modules it needs (config, data, tokenizers, the
HTTP micro-batcher and handler, the run artifacts) are its own copies,
which the tests hold equal to the originals.
"""

__version__ = "0.1.0"
