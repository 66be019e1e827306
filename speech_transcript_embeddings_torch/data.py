"""Data pipeline of the port: the JAX package's framework-free data code,
re-exported.

``speech_transcript_embeddings_tpu/data/`` (bucketed batching, the host
prefetch thread, the synthetic and Common Voice sources, the tokenizers) and
``utils/artifacts.py`` import numpy and the standard library, not JAX, so
the port shares them rather than copy them, as ``config.py`` shares the
config dataclasses: both packages batch the same clips in the same order.
"""

from speech_transcript_embeddings_tpu.data.pipeline import (  # noqa: F401
    DataPipeline,
    prefetch,
)
from speech_transcript_embeddings_tpu.data.sources import (  # noqa: F401
    SyntheticSource,
    make_source,
)
from speech_transcript_embeddings_tpu.data.tokenizers import (  # noqa: F401
    SimpleWordTokenizer,
    Tokenizer,
    resolve_tokenizer,
)
from speech_transcript_embeddings_tpu.utils import artifacts  # noqa: F401
