"""The embed window's share of the card's bf16 peak: model FLOPs of the
conformer, pooling and projection of every clip at its valid frames
(``flops.py``) ÷ the window's seconds (``host_clock``) ÷ 989 TFLOP/s, in
%. Moves ``embed_clips_per_s``."""

from benchmark import readers


def read(run):
    return readers.mfu_pct(run)
