"""The device-bound train window's share of the card's bf16 peak: model
FLOPs of every step (``flops.py``: forward, activation gradients where a
gradient flows, weight gradients of the trainable split, no recompute) ÷
the window's seconds (``host_clock``) ÷ 989 TFLOP/s, in %. Moves
``train_clips_per_s.b64``."""

from benchmark import readers


def read(run):
    return readers.mfu_pct(run)
