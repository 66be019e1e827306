"""The one generator of the benchmark's traffic: it reads a mix's data file
(``traffic/<mix>.json``) and makes, from ``--seed``, what a cell's entry
feeds the program.

A mix's lengths are one fixed set (drawn from the file's ``length_seed``),
so that every seed gives the same work; the run's seed orders it and draws
the waveforms and the transcripts. Lengths come from a named distribution:

* ``cv``: Common Voice pt clip lengths, lognormal (median ``median_s``,
  σ_log ``sigma_log``) clipped to [``min_s``, ``max_s``]; a frozen copy of
  ``speech_transcript_embeddings_torch/utils/bench.sample_cv_lengths``
  (itself bench.py's ``_sample_cv_lengths``);
* ``uniform``: whole samples in [``min_samples``, ``max_samples``).

Batched mixes (``train``, ``embed``) put each clip in the smallest bucket
that holds it (a frozen copy of ``utils/bench.bucket_mix``: a bucket's
remainder is dropped) and cycle the batches in an order that interleaves
the buckets in proportion (``interleave``), so that any stretch of the
cycle reads the mix.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLE_RATE = 16000
AMPLITUDE = 0.05        # the waveforms' standard deviation (bench.py's)
FIRST_ID = 4            # transcript ids are drawn from [FIRST_ID, vocab)


def load(name: str) -> dict:
    """The mix ``traffic/<name>.json``."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed (stable across
    processes, unlike ``hash``)."""
    digest = hashlib.sha256(f"{seed}:{purpose}".encode()).hexdigest()
    return int(digest[:15], 16)


# ---- lengths ----------------------------------------------------------------

def sample_cv_lengths(n: int, rng: np.random.Generator, median_s: float = 4.2,
                      sigma_log: float = 0.45, min_s: float = 1.0,
                      max_s: float = 30.0) -> np.ndarray:
    """Frozen copy of ``utils/bench.sample_cv_lengths`` (its constants made
    parameters): clip lengths in samples at 16 kHz."""
    secs = np.clip(rng.lognormal(np.log(median_s), sigma_log, size=n),
                   min_s, max_s)
    return (secs * SAMPLE_RATE).astype(np.int64)


def lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` clip lengths of the mix's ``lengths`` group, from its
    ``length_seed``."""
    rng = np.random.default_rng(spec["length_seed"])
    if spec["dist"] == "cv":
        return sample_cv_lengths(n, rng, spec["median_s"], spec["sigma_log"],
                                 spec["min_s"], spec["max_s"])
    if spec["dist"] == "uniform":
        return rng.integers(spec["min_samples"], spec["max_samples"], size=n)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def bucket_of(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that holds ``n`` samples (the largest when none
    does)."""
    buckets = sorted(buckets)
    return buckets[min(bisect.bisect_left(buckets, n), len(buckets) - 1)]


def bucket_mix(lens: Sequence[int], buckets: Sequence[int], max_samples: int,
               batch: int) -> List[Tuple[int, List[int], int]]:
    """Frozen copy of ``utils/bench.bucket_mix``: [(bucket, its clips'
    lengths, full batches)] of each bucket with a full batch, shortest
    first; a clip is capped at ``max_samples``."""
    per: Dict[int, List[int]] = {b: [] for b in sorted(buckets)}
    for n in lens:
        n = min(int(n), max_samples)
        per[bucket_of(n, buckets)].append(n)
    return [(b, ns, len(ns) // batch) for b, ns in per.items()
            if len(ns) >= batch]


def interleave(counts: Sequence[int]) -> List[int]:
    """Indices ``i`` repeated ``counts[i]`` times, spread evenly (smooth
    weighted round robin): every stretch holds each index in about its
    share."""
    total, cur, out = sum(counts), [0] * len(counts), []
    for _ in range(total):
        for i, c in enumerate(counts):
            cur[i] += c
        pick = max(range(len(counts)), key=lambda i: cur[i])
        cur[pick] -= total
        out.append(pick)
    return out


# ---- batched mixes ----------------------------------------------------------

def batch_plan(mix: dict) -> List[Tuple[int, List[int]]]:
    """The fixed cycle of a batched mix: [(bucket, the batch's valid
    lengths)] in interleaved order. Clips are dealt to batches in the
    fixed order here; ``order_plan`` shuffles them by seed."""
    b = mix["batch"]
    lens = lengths(mix["lengths"], mix["clips"])
    groups = bucket_mix(lens, mix["buckets"], mix["max_samples"], b)
    cursor = [0] * len(groups)
    out = []
    for g in interleave([k for _, _, k in groups]):
        bucket, ns, _ = groups[g]
        out.append((bucket, ns[cursor[g] * b:(cursor[g] + 1) * b]))
        cursor[g] += 1
    return out


def order_plan(plan: List[Tuple[int, List[int]]], seed: int
               ) -> List[Tuple[int, List[int]]]:
    """The plan with each bucket's clips shuffled among its batches by
    ``seed``: the same buckets in the same order, the same set of
    lengths."""
    rng = np.random.default_rng(sub_seed(seed, "order"))
    by_bucket: Dict[int, List[int]] = {}
    for bucket, ns in plan:
        by_bucket.setdefault(bucket, []).extend(ns)
    for bucket in by_bucket:
        by_bucket[bucket] = list(rng.permutation(by_bucket[bucket]))
    out = []
    for bucket, ns in plan:
        rows, by_bucket[bucket] = (by_bucket[bucket][:len(ns)],
                                   by_bucket[bucket][len(ns):])
        out.append((bucket, [int(n) for n in rows]))
    return out


def waveforms(torch, lens: Sequence[int], width: int, generator, device):
    """``[len(lens), width]`` fp32 waveforms on ``device``: normal noise of
    ``AMPLITUDE`` over each clip's valid samples, zeros after, in one draw
    from ``generator``."""
    wav = torch.randn((len(lens), width), generator=generator,
                      device=device) * AMPLITUDE
    n = torch.as_tensor(list(lens), device=device)
    return wav * (torch.arange(width, device=device)[None] < n[:, None])


def transcripts(torch, rows: int, text_len: int, vocab: int, generator,
                device):
    """bench.py's clean and corrupted transcripts: random ids in
    ``[FIRST_ID, vocab)``, no padding."""
    ids = torch.randint(FIRST_ID, vocab, (2, rows, text_len),
                        generator=generator, device=device, dtype=torch.int64)
    ones = torch.ones((rows, text_len), dtype=torch.int64, device=device)
    return {"input_ids_pos": ids[0], "attention_mask_pos": ones,
            "input_ids_neg": ids[1], "attention_mask_neg": ones.clone()}


def train_pool(torch, mix: dict, seed: int, vocab: int, device) -> List[dict]:
    """The device-resident batches of a train mix in cycle order, each
    ``{waveform, num_samples, input_ids_pos, ...}`` (one distinct batch a
    step through the cycle), drawn bucket by bucket in a few large calls."""
    plan = order_plan(batch_plan(mix), seed)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "inputs"))
    out: List[dict] = [None] * len(plan)
    for bucket in sorted({b for b, _ in plan}):
        idx = [i for i, (b, _) in enumerate(plan) if b == bucket]
        lens = [n for i in idx for n in plan[i][1]]
        wav = waveforms(torch, lens, bucket, gen, device)
        text = transcripts(torch, len(lens), mix["text_len"], vocab, gen,
                           device)
        b = mix["batch"]
        for j, i in enumerate(idx):
            rows = slice(j * b, (j + 1) * b)
            out[i] = {"waveform": wav[rows],
                      "num_samples": torch.as_tensor(
                          plan[i][1], dtype=torch.int32, device=device),
                      **{k: v[rows] for k, v in text.items()}}
    return out


def host_clips(torch, lens: Sequence[int], seed: int, purpose: str, device
               ) -> List[np.ndarray]:
    """One host array a clip (its valid samples only), drawn in one call on
    ``device`` and copied to the host once."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, purpose))
    total = int(sum(lens))
    flat = (torch.randn(total, generator=gen, device=device)
            * AMPLITUDE).cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(lens)])
    return [flat[offsets[i]:offsets[i + 1]] for i in range(len(lens))]


def embed_pool(torch, mix: dict, seed: int, device
               ) -> List[Tuple[int, List[np.ndarray]]]:
    """The host batches of an embed mix in cycle order: [(bucket, one host
    array a clip)]."""
    plan = order_plan(batch_plan(mix), seed)
    lens = [n for _, ns in plan for n in ns]
    clips = host_clips(torch, lens, seed, "clips", device)
    out, at = [], 0
    for bucket, ns in plan:
        out.append((bucket, clips[at:at + len(ns)]))
        at += len(ns)
    return out

