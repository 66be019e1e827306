"""The bulk embedding cells: a closed loop of host batches of the mix through
the program's ``inference/embed.py::Embedder.embed_audios`` (host padding,
copy to the card, log-mel, the conformer, pooling, projection, L2 norm,
copy back), one batch after the other through the mix's cycle.

Set-up builds the serving model from the benchmark's weights and runs each
bucket of the cycle twice. The window calls until ``--seconds`` have
passed: ``embed_clips_per_s`` is the clips embedded ÷ the window's seconds
(each call ends with its embeddings on the host). With ``--trace 1`` the
cycle goes on for the mix's ``trace_batches`` under the profiler.

``correct``: a sample of the clips the window embedded (``sample`` of them
drawn from the seed, and the longest), each clip's last embedding against
the reference's.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from benchmark import common, flops, traffic
from benchmark.entries import embedding


def _attention_calls(config: dict, clips: List[np.ndarray]):
    m = config["model"]
    return ([flops.valid_frames(m["frontend"], len(c)) for c in clips],
            m["audio"]["num_layers"], 0)


def run(ctx, cell, variant=None) -> dict:
    torch, device = ctx.torch, ctx.device
    phases = common.Phases()
    embedder = embedding.make_embedder(torch, cell, ctx.seed, device, variant)
    phases.mark("weights, model")
    pool = traffic.embed_pool(torch, cell.mix, ctx.seed, device)
    phases.mark("clips")
    for bucket in sorted({b for b, _ in pool}):
        batch = next(clips for b, clips in pool if b == bucket)
        for _ in range(2):
            embedder.embed_audios(batch)
    phases.mark("warm-up")
    ctx.mark_setup()

    ctx.reset_peak()
    ran, last = [], {}
    t0 = time.perf_counter()
    while True:
        i = len(ran) % len(pool)
        last[i] = embedder.embed_audios(pool[i][1])
        ran.append(i)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    host = ctx.host_load(window_s)
    peak = ctx.peak_memory()
    clips = sum(len(pool[i][1]) for i in ran)
    per_batch = {i: flops.embed_audio(cell.config,
                                      [len(c) for c in pool[i][1]])
                 for i in last}

    stretch = None
    if ctx.trace:
        traced = [(len(ran) + k) % len(pool)
                  for k in range(cell.mix["trace_batches"])]
        with ctx.stretch() as s:
            for i in traced:
                embedder.embed_audios(pool[i][1])
        stretch = {"window_s": s.window_s, "events": s.events,
                   "steps": len(traced),
                   "attention": [_attention_calls(cell.config, pool[i][1])
                                 for i in traced]}

    done = [(i, r) for i in sorted(last) for r in range(len(pool[i][1]))]
    rng = np.random.default_rng(traffic.sub_seed(ctx.seed, "sample"))
    picked = [done[j] for j in embedding.sample(
        rng, [len(pool[i][1][r]) for i, r in done], cell.mix["sample"])]
    clips_checked = [pool[i][1][r] for i, r in picked]
    answers = [last[i][r] for i, r in picked]
    del embedder, pool, last
    ctx.free()
    phases.skip()
    numbers = embedding.readings(torch, cell, ctx.seed, clips_checked,
                                 answers, device)
    phases.mark("reference")
    return {
        "attempted": clips, "failed": 0,
        "end_to_end": {"embed_clips_per_s": clips / window_s},
        "readings": numbers,
        "memory_peak_bytes": peak,
        "window": {"seconds": window_s, "steps": len(ran), "clips": clips,
                   "model_flops": sum(per_batch[i] for i in ran)},
        "stretch": stretch,
        "report": {"checked": len(picked), "host": host},
        "notes": [phases.note()],
    }
