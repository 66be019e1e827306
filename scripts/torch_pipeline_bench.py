#!/usr/bin/env python
"""Host input-pipeline throughput of the PyTorch/CUDA port at flagship
shapes (B = 64, 10 s clips): the port of ``scripts/pipeline_bench.py``.

    python scripts/torch_pipeline_bench.py [--device cuda|cpu]

Runs the port's ``data/`` pipeline on the host (example fetch → tokenise
→ corrupt → bucket → native pad/collate) over the synthetic source of
``SAMPLES`` clips, and breaks out the cost of each stage:

* end to end: two epochs' batches (after one warm epoch), clips/s;
* the synthetic source's tone synthesis alone, ms a clip (a real source
  decodes instead: native WAV, or soundfile);
* ``data/native_audio.pad_batch`` (native, releases the GIL) alone, ms a
  batch of 64 clips;
* the pipeline without the synthesis, ms a clip and clips/s on one core;
* the cores the process sees (``os.cpu_count`` and its affinity).

With ``--device cuda`` it also puts one more epoch's batches on the card
as the training loop does (``training/train_step._to_device``), the
window ending in a device sync: clips/s with the host-to-device copy.
These answer whether the loader, which ``bench_torch.py`` bypasses, can
feed the train step's clips/s on the card. ``--device cuda`` without a
card raises. Prints one line a reading, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SAMPLES = 2048
BATCH = 64
AUDIO_SECONDS = 10
PAD_CALLS = 10


def make_pipeline(samples: int = SAMPLES, batch: int = BATCH):
    """pipeline_bench.py's source and pipeline (seed 0, one 10 s bucket):
    → (data config, source, pipeline)."""
    from speech_transcript_embeddings_torch import config as c
    from speech_transcript_embeddings_torch.data.pipeline import DataPipeline
    from speech_transcript_embeddings_torch.data.sources import make_source
    from speech_transcript_embeddings_torch.data.tokenizers import (
        SimpleWordTokenizer,
    )
    asamps = AUDIO_SECONDS * 16000
    data = c.DataConfig(
        dataset="synthetic", num_synthetic_samples=samples, batch_size=batch,
        max_text_length=64, audio_buckets=(asamps,), max_audio_samples=asamps)
    return (data, make_source(data, seed=0),
            DataPipeline(data, SimpleWordTokenizer(vocab_size=512), seed=0))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import numpy as np
    import torch
    from speech_transcript_embeddings_torch.data import native_audio
    from speech_transcript_embeddings_torch.inference.embed import (
        resolve_device,
    )
    from speech_transcript_embeddings_torch.training import train_step as ts
    from speech_transcript_embeddings_torch.utils import bench as ub
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    data, source, pipe = make_pipeline(SAMPLES, BATCH)
    asamps = data.max_audio_samples

    # end-to-end epochs (warm first)
    n = sum(1 for _ in pipe.epoch_batches(source, "train", epoch=0))
    t0 = time.perf_counter()
    clips = 0
    for epoch in (1, 2):
        for b in pipe.epoch_batches(source, "train", epoch):
            clips += b["waveform"].shape[0]
    dt = time.perf_counter() - t0
    e2e = clips / dt

    # the source alone (synthetic tone generation)
    t0 = time.perf_counter()
    for i in range(SAMPLES):
        source.example_at("train", i)
    src_per_clip = (time.perf_counter() - t0) / SAMPLES

    # pad/collate alone (native; releases the GIL)
    rng = np.random.default_rng(0)
    raw = [rng.normal(size=asamps - 10000).astype(np.float32)
           for _ in range(BATCH)]
    for _ in range(2):
        native_audio.pad_batch(raw, asamps)
    t0 = time.perf_counter()
    for _ in range(PAD_CALLS):
        native_audio.pad_batch(raw, asamps)
    pad_per_batch = (time.perf_counter() - t0) / PAD_CALLS

    h2d = None
    if cuda:
        t0 = time.perf_counter()
        placed = 0
        for b in pipe.epoch_batches(source, "train", 3):
            on_card = {k: ts._to_device(v, device) for k, v in b.items()}
            placed += on_card["waveform"].shape[0]
        torch.cuda.synchronize(device)
        h2d = placed / (time.perf_counter() - t0)

    per_clip = 1.0 / e2e
    excl = max(per_clip - src_per_clip, 1e-9)
    out = {"samples": SAMPLES, "batch": BATCH, "seconds": AUDIO_SECONDS,
           "cores": os.cpu_count() or 1,
           "cores_in_affinity": len(os.sched_getaffinity(0)),
           "native_pad": native_audio.get_lib() is not None,
           "batches_per_epoch": n, "clips": clips, "seconds_e2e": dt,
           "clips_per_s": e2e, "source_ms_per_clip": src_per_clip * 1e3,
           "pad_ms_per_batch": pad_per_batch * 1e3,
           "pad_ms_per_clip": pad_per_batch / BATCH * 1e3,
           "excl_synthesis_ms_per_clip": excl * 1e3,
           "excl_synthesis_clips_per_s": 1.0 / excl,
           "h2d_clips_per_s": h2d, "device": str(device),
           "card": ub.card_line(device.index or 0) if cuda else "cpu"}
    print(f"host cores visible: {out['cores']} ({out['cores_in_affinity']} "
          f"in this process's affinity)")
    print(f"end-to-end: {clips} clips in {dt:.2f}s = {e2e:.0f} clips/s "
          f"({n} batches/epoch, B={BATCH}, {AUDIO_SECONDS}s clips)")
    print(f"  source synthesis (test-only): {out['source_ms_per_clip']:.2f} "
          f"ms/clip")
    print(f"  pad/collate (native, GIL-free): {out['pad_ms_per_batch']:.1f} "
          f"ms/batch = {out['pad_ms_per_clip']:.2f} ms/clip")
    print(f"  pipeline excl. synthesis: {excl * 1e3:.2f} ms/clip = "
          f"{1 / excl:.0f} clips/s/core")
    if h2d is not None:
        print(f"  one epoch placed on {out['card']}: {h2d:.0f} clips/s")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
