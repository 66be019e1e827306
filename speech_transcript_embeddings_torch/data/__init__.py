"""Data pipeline of the port: bucketed batching, the host prefetch thread,
the synthetic and Common Voice sources, the tokenizers and the run
artifacts. Copies of the JAX package's framework-free modules (numpy and
the standard library only), so both packages batch the same clips in the
same order without the port importing the JAX package.
"""

from speech_transcript_embeddings_torch.data.corruption import (  # noqa: F401
    create_corrupted_transcript,
)
from speech_transcript_embeddings_torch.data.pipeline import (  # noqa: F401
    DataPipeline,
    prefetch,
)
from speech_transcript_embeddings_torch.data.sources import (  # noqa: F401
    SyntheticSource,
    make_source,
)
from speech_transcript_embeddings_torch.data.tokenizers import (  # noqa: F401
    SimpleWordTokenizer,
    Tokenizer,
    resolve_tokenizer,
)
from speech_transcript_embeddings_torch.utils import artifacts  # noqa: F401
