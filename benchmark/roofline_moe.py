"""The least time the card could take for the routed experts' products of
one MoE layer (``moe_experts``: each expert's SwiGLU over the rows routed
to it): the larger of its operations over the bf16 peak and its bytes over
the memory bandwidth (``card.py``).

At the rows the layer's counter (``MoE.expert_rows``) gives: 3 products of
``2·hidden·width`` FLOP a row; the weights of every expert that got a row
read once (three ``hidden × width`` matrices, bf16), and each row's input
(``hidden``), its activated intermediate (``width``, written once and read
once) and its output (``hidden``), bf16.
"""

from __future__ import annotations

from typing import Sequence

BF16 = 2


def experts_bound_s(rows_per_expert: Sequence[int], hidden: int, width: int,
                    peak_flops: float, peak_bytes: float) -> float:
    """Seconds of one layer's routed products over these rows."""
    rows = sum(rows_per_expert)
    used = sum(1 for r in rows_per_expert if r > 0)
    flops = rows * 3 * 2 * hidden * width
    nbytes = (used * 3 * hidden * width
              + rows * (hidden + 2 * width + hidden)) * BF16
    return max(flops / peak_flops, nbytes / peak_bytes)
