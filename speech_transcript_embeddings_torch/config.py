"""Configuration of the port: the JAX package's dataclasses, re-exported.

``speech_transcript_embeddings_tpu/config.py`` is framework-free (stdlib
dataclasses only), so the port shares it rather than copy it: one config
schema for both packages, and a checkpoint's ``metadata.json`` reads the
same in either.
"""

from speech_transcript_embeddings_tpu.config import (  # noqa: F401
    AudioEncoderConfig,
    DataConfig,
    ExperimentConfig,
    FreezeConfig,
    FrontendConfig,
    HeadsConfig,
    LossConfig,
    ModelConfig,
    OptimizerConfig,
    TextEncoderConfig,
    TrainConfig,
    flagship_model_config,
    parse_overrides,
    retrieval_model_config,
    roberta_model_config,
    tiny_model_config,
)
