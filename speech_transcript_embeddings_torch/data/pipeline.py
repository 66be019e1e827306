# The port's copy of speech_transcript_embeddings_tpu/data/pipeline.py: the port imports
# nothing of the JAX package. Keep the two in step.
"""Host-side input pipeline: corruption → tokenisation → static-shape bucketing.

Replaces the reference's DataLoader stack (12 worker processes doing per-item
featurisation — trainer_unfreeze.py:1425-1453) with a lean host pipeline that only
tokenises and pads: **audio featurisation runs on the TPU** inside the jitted step
(see ops/frontend.py), so the host just ships raw waveforms.

TPU-first: every batch has one of a small, fixed set of shapes — audio is padded to
a length *bucket* (DataConfig.audio_buckets) and text to ``max_text_length`` — so
XLA compiles each bucket once (the reference's vestigial ``--bucket`` flag,
implemented for real; SURVEY.md §5.7). Eval tails are padded with dummy rows and
carry an ``example_mask`` so metrics stay exact.

Per-epoch corruption re-randomisation matches the reference's stochastic
``__getitem__`` (trainer_unfreeze.py:832-837) but is fully seeded: epoch ``e`` of
split ``s`` always produces the same corruptions for a given seed.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterator, List, Optional

import numpy as np

from speech_transcript_embeddings_torch.config import DataConfig
from speech_transcript_embeddings_torch.data import native_audio
from speech_transcript_embeddings_torch.data.corruption import create_corrupted_transcript
from speech_transcript_embeddings_torch.data.sources import Example
from speech_transcript_embeddings_torch.data.tokenizers import Tokenizer

Batch = Dict[str, np.ndarray]


class DataPipeline:
    def __init__(self, cfg: DataConfig, tokenizer: Tokenizer, seed: int = 42):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.seed = seed
        self.buckets = sorted(cfg.audio_buckets)

    # ------------------------------------------------------------------ utils

    def _bucket_for(self, n_samples: int) -> int:
        i = bisect.bisect_left(self.buckets, n_samples)
        return self.buckets[min(i, len(self.buckets) - 1)]

    def _encode_example(self, ex: Example, rng: np.random.Generator,
                        corruption_probability: float) -> dict:
        audio = ex.audio
        if len(audio) > self.cfg.max_audio_samples:
            audio = audio[: self.cfg.max_audio_samples]
        # peak normalisation happens batched in _emit (native pad_batch)
        corrupt = create_corrupted_transcript(ex.sentence, rng,
                                              corruption_probability)
        ids_pos, mask_pos = self.tokenizer.encode(ex.sentence,
                                                  self.cfg.max_text_length)
        ids_neg, mask_neg = self.tokenizer.encode(corrupt,
                                                  self.cfg.max_text_length)
        return {
            "audio": audio.astype(np.float32),
            "ids_pos": ids_pos, "mask_pos": mask_pos,
            "ids_neg": ids_neg, "mask_neg": mask_neg,
        }

    def _emit(self, items: List[dict], bucket_len: int,
              pad_to_full: bool) -> Optional[Batch]:
        b = self.cfg.batch_size
        n_real = len(items)
        if n_real == 0:
            return None
        if n_real < b:
            if not pad_to_full:
                return None
            items = items + [items[0]] * (b - n_real)
        # batched peak-normalise (|x|>1 only, reference processor.py:91-92) +
        # truncate + zero-pad in the native C++ library (threaded; Python
        # fallback inside pad_batch when no compiler is available)
        waveform, num_samples = native_audio.pad_batch(
            [it["audio"] for it in items], bucket_len)
        batch = {
            "waveform": waveform,
            "num_samples": num_samples,
            "input_ids_pos": np.stack([it["ids_pos"] for it in items]),
            "attention_mask_pos": np.stack([it["mask_pos"] for it in items]),
            "input_ids_neg": np.stack([it["ids_neg"] for it in items]),
            "attention_mask_neg": np.stack([it["mask_neg"] for it in items]),
            "example_mask": (np.arange(b) < n_real).astype(np.float32),
        }
        return batch

    # ------------------------------------------------------------------ counts

    def count_epoch_batches(self, source, split: str,
                            drop_last: Optional[bool] = None) -> Optional[int]:
        """Exact number of batches ``epoch_batches`` will yield, or None when
        the source can't report lengths.

        Under ``drop_last`` each bucket independently drops its remainder
        (< batch_size tail), so the count depends only on the audio-length
        histogram — not on the shuffle order: per bucket ``n_b // B``. The
        naive ``N // B`` estimate overcounts by up to (num_buckets-1)·(B-1)/B
        batches, which would make the linear-decay schedule never reach its
        endpoint (the reference's schedule is exact because it has a single
        unbucketed DataLoader, trainer_unfreeze.py:1525-1541).
        """
        is_train = split == "train"
        drop_last = is_train if drop_last is None else drop_last
        lengths_fn = getattr(source, "audio_lengths", None)
        if lengths_fn is None:
            return None
        per_bucket: Dict[int, int] = {b: 0 for b in self.buckets}
        for n in lengths_fn(split):
            per_bucket[self._bucket_for(
                min(int(n), self.cfg.max_audio_samples))] += 1
        b = self.cfg.batch_size
        if drop_last:
            return sum(c // b for c in per_bucket.values())
        return sum(-(-c // b) for c in per_bucket.values())

    # ------------------------------------------------------------------ epochs

    def epoch_batches(self, source, split: str, epoch: int,
                      corruption_probability: Optional[float] = None,
                      shuffle: Optional[bool] = None,
                      drop_last: Optional[bool] = None) -> Iterator[Batch]:
        """Yield fixed-shape batches for one epoch.

        Train defaults: shuffle=True, drop_last=True (reference
        trainer_unfreeze.py:1425-1433); eval: ordered, tail padded + masked.
        """
        is_train = split == "train"
        shuffle = is_train if shuffle is None else shuffle
        drop_last = is_train if drop_last is None else drop_last
        prob = (self.cfg.corruption_probability
                if corruption_probability is None else corruption_probability)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch,
                                    {"train": 0, "validation": 1, "test": 2}[split]]))

        if hasattr(source, "example_at"):
            if shuffle:
                # full-dataset shuffle: permute an index array (cheap — lengths
                # and rows are addressed lazily) so every epoch is a true
                # permutation, like the reference's DataLoader shuffle
                # (trainer_unfreeze.py:1425-1433). A bounded reservoir would
                # correlate batch composition with file order under bucketing.
                indices = rng.permutation(source.num_examples(split))
            else:
                indices = range(source.num_examples(split))
            fetch = lambda i: source.example_at(split, int(i))  # noqa: E731
            if self.cfg.decode_workers > 1:
                # ordered bounded thread pool for the fetch/decode stage only:
                # the corruption rng stream stays sequential in this consumer,
                # so batches are byte-identical to the sequential path
                examples = _bounded_thread_map(fetch, indices,
                                               self.cfg.decode_workers)
            else:
                examples = map(fetch, indices)
        elif shuffle:
            examples = _shuffled(source.examples(split), rng, buffer_size=4096)
        else:
            examples = source.examples(split)

        pending: Dict[int, List[dict]] = {blen: [] for blen in self.buckets}
        for ex in examples:
            item = self._encode_example(ex, rng, prob)
            blen = self._bucket_for(len(item["audio"]))
            pending[blen].append(item)
            if len(pending[blen]) == self.cfg.batch_size:
                yield self._emit(pending[blen], blen, pad_to_full=False)
                pending[blen] = []
        if not drop_last:
            for blen, items in pending.items():
                batch = self._emit(items, blen, pad_to_full=True)
                if batch is not None:
                    yield batch


def _bounded_thread_map(fn, iterable, workers: int, ahead: int = 0):
    """Ordered ``map(fn, iterable)`` over a thread pool with a bounded number
    of in-flight results — parallelism without materializing the epoch (a
    plain ``Executor.map`` would submit every item up front and hold every
    decoded clip in memory)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    ahead = ahead or workers * 2
    with ThreadPoolExecutor(max_workers=workers) as pool:
        dq: deque = deque()
        for x in iterable:
            dq.append(pool.submit(fn, x))
            if len(dq) >= ahead:
                yield dq.popleft().result()
        while dq:
            yield dq.popleft().result()


def prefetch(iterator, depth: int = 2):
    """Run the host pipeline in a background thread, keeping up to ``depth``
    ready batches — overlaps tokenisation/padding with device compute (the
    reference used 12 DataLoader workers for this plus featurisation; our
    featurisation is on-device so one thread suffices).

    An abandoned generator (consumer breaks out early, e.g. the preemption
    exit) unblocks and stops the worker on close — no leaked thread holding
    device-resident batches."""
    if depth <= 0:
        yield from iterator
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    error = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    return
        except BaseException as e:   # propagate into the consumer
            error.append(e)
        _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()


def _shuffled(iterator, rng: np.random.Generator, buffer_size: int):
    """Streaming shuffle with a bounded reservoir buffer."""
    buf = []
    for item in iterator:
        buf.append(item)
        if len(buf) >= buffer_size:
            idx = int(rng.integers(len(buf)))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf
