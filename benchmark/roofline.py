"""The least time the card could take for the relative_key attention of one
conformer block, forward (K3) and backward (K4), at a batch's valid frames:
the larger of its operations over the bf16 peak and its bytes over the
memory bandwidth (``card.py``).

A frozen copy of ``chip_smoke.py``'s ``flash_bound`` arithmetic, counted at
each clip's valid frames ``t`` for queries and keys alike, a head at a time:

* forward: ``q·kᵀ`` and ``p·v``, 4·t²·hd, and ``q·Eᵀ`` over the distance
  table, 2·t·P·hd; q, k, v read, the output written (bf16), the row
  log-sum-exp written (fp32), the table read;
* backward: the scores again, ``dp = do·vᵀ``, ``dv = pᵀ·do``, ``dq = ds·k``,
  ``dk = dsᵀ·q``, 10·t²·hd, and ``q·Eᵀ``, ``dq += dqE·E``, ``dE = dqEᵀ·q``,
  6·t·P·hd; q, k, v, out, dout read and dq, dk, dv written (bf16), the
  log-sum-exp read, the table read and its gradient written.
"""

from __future__ import annotations

from typing import Sequence

BF16 = 2


def attention_bound_s(frames: Sequence[int], heads: int, head_dim: int,
                      num_pos: int, peak_flops: float, peak_bytes: float,
                      backward: bool) -> float:
    """Seconds of one block's call over clips of ``frames`` valid frames."""
    per_t2, per_tp = (10, 6) if backward else (4, 2)
    tensors = 8 if backward else 4
    flops = nbytes = 0.0
    for t in frames:
        flops += heads * (per_t2 * t * t * head_dim + per_tp * t * num_pos
                          * head_dim)
        nbytes += heads * t * (tensors * head_dim * BF16 + 4)
    nbytes += (2 if backward else 1) * num_pos * head_dim * BF16
    return max(flops / peak_flops, nbytes / peak_bytes)
