"""The bulk text-embedding cells: a closed loop of host batches of token ids
through the program's ``inference/embed.py::Embedder.embed_ids`` (row
padding, copy to the card, the transcript tower, pooling, projection, L2
norm, copy back), one batch after the other through the mix's cycle.
Tokenising is left out: the ids are made by the benchmark.

The mix: ``transcripts`` lengths in tokens, lognormal (median
``median_tokens``, σ_log ``sigma_log``) clipped to [``min_tokens``,
``max_tokens``] from ``length_seed`` (the same set in every run), ordered
by the run's seed; ids uniform in [4, vocab) from the seed, right-padded to
``text_len`` with the Embedder's pad id, as ``embed_texts`` pads; ``batch``
transcripts a call.

Set-up builds the serving model (the weights made in bf16 tensor by tensor,
``weights_deepseek_v2.py``) and embeds two batches. The window calls until
``--seconds`` have passed: ``embed_clips_per_s`` is the transcripts
embedded ÷ the window's seconds (each call ends with its embeddings on the
host). With ``--trace 1`` the cycle goes on for the mix's
``trace_batches`` under the profiler, and each MoE layer's per-expert row
counts (``expert_rows``, where the program keeps them) are read after the
stretch.

``correct``: a sample of the transcripts the window embedded (``sample``
drawn from the seed, and the longest), each one's last embedding against
the plain reference's (``reference/deepseek_v2.py``, fp32, layer by layer,
run after the program is freed): ``embedding_gap``, the widest L2 distance
of the unit vectors. Reported beside it, without a limit:
``route_flip_share``, the share of the sample's valid tokens whose set of
experts at layer 1 differs between the program (the sample embedded once
more after the window) and the reference.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from benchmark import common, flops_moe, traffic
from benchmark.entries import embedding
from benchmark.reference import deepseek_v2 as ref_tower
from benchmark.weights_deepseek_v2 import fill, getter

ROUTE_LAYER = 1          # the first MoE layer: its routes are compared


def port_config(config: dict, mix: dict):
    """The program's ``ExperimentConfig`` of a configuration file and a
    text mix."""
    from speech_transcript_embeddings_torch.config import ExperimentConfig
    return ExperimentConfig().with_overrides({
        "model": config["model"], "freeze": config["freeze"],
        "loss": config["loss"], "optimizer": config["optimizer"],
        "data": {"batch_size": mix["batch"],
                 "max_text_length": mix["text_len"]}})


def make_embedder(torch, cell, seed: int, device):
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    from speech_transcript_embeddings_torch.models.dual_encoder import (
        DualEncoderModel,
    )
    cfg = port_config(cell.config, cell.mix)
    with torch.device(device):
        model = DualEncoderModel(cfg.model)
    fill(model, cell.config, seed)
    return Embedder(cfg, model.eval().requires_grad_(False))


def text_lengths(spec: dict, n: int) -> np.ndarray:
    rng = np.random.default_rng(spec["length_seed"])
    tokens = rng.lognormal(np.log(spec["median_tokens"]), spec["sigma_log"],
                           size=n)
    return np.clip(np.rint(tokens), spec["min_tokens"],
                   spec["max_tokens"]).astype(np.int64)


def text_pool(torch, mix: dict, seed: int, vocab: int, pad_id: int, device
              ) -> List[tuple]:
    """The host batches of the cycle: [(ids, mask)], int32 ``[batch,
    text_len]``, the ids drawn in one call on ``device``."""
    n, width, b = mix["transcripts"], mix["text_len"], mix["batch"]
    lens = np.random.default_rng(traffic.sub_seed(seed, "order")).permutation(
        text_lengths(mix["lengths"], n))
    gen = torch.Generator(device).manual_seed(traffic.sub_seed(seed,
                                                               "transcripts"))
    ids = torch.randint(traffic.FIRST_ID, vocab, (n, width), generator=gen,
                        device=device, dtype=torch.int32).cpu().numpy()
    mask = (np.arange(width)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, pad_id).astype(np.int32)
    return [(ids[i:i + b], mask[i:i + b]) for i in range(0, n - b + 1, b)]


def _moe_layers(model) -> List:
    """The modules that keep a per-expert row counter (``expert_rows``,
    the last call's counts on the device), where the program has them."""
    return [m for m in model.modules() if hasattr(m, "expert_rows")]


def _program_routes(embedder, ids, mask) -> np.ndarray:
    """The program's experts at ``ROUTE_LAYER`` for each token of the rows
    ``ids`` (one more call, after the window): ``[rows, text_len, k]``."""
    router = getattr(embedder.model.text_encoder,
                     f"layer_{ROUTE_LAYER}").mlp.gate
    seen = []
    hook = router.register_forward_hook(
        lambda mod, args, out: seen.append(out[1]))
    try:
        embedder.embed_ids(ids, mask)
    finally:
        hook.remove()
    width = ids.shape[1]
    return seen[0].view(-1, width, seen[0].shape[-1])[:len(ids)].cpu().numpy()


def flip_share(prog: np.ndarray, ref: np.ndarray, mask: np.ndarray) -> float:
    """The share of valid tokens whose sets of experts differ."""
    differ = (np.sort(prog, -1) != np.sort(ref, -1)).any(-1)
    return float(differ[mask == 1].mean())


def reference(torch, config: dict, seed: int, ids: np.ndarray,
              mask: np.ndarray, device, precision: str = "fp32"):
    """The reference's embeddings ``[rows, D]`` and its experts at
    ``ROUTE_LAYER`` ``[rows, text_len, k]``, all rows in one call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tower = ref_tower.Tower(config["model"], getter(config, seed, device),
                            precision)
    with torch.no_grad():
        emb = tower.embed(torch.from_numpy(ids).long().to(device),
                          torch.from_numpy(mask).to(device))
    routes = tower.routes[ROUTE_LAYER].view(len(ids), ids.shape[1], -1)
    return emb.cpu().numpy(), routes.cpu().numpy()


def run(ctx, cell) -> dict:
    torch, device = ctx.torch, ctx.device
    phases = common.Phases()
    embedder = make_embedder(torch, cell, ctx.seed, device)
    phases.mark("weights, model")
    pool = text_pool(torch, cell.mix, ctx.seed,
                     cell.config["model"]["text"]["vocab_size"],
                     embedder.tokenizer.pad_token_id, device)
    phases.mark("transcripts")
    for i in range(2):
        embedder.embed_ids(*pool[i])
    phases.mark("warm-up")
    ctx.mark_setup()

    ctx.reset_peak()
    ran, last = [], {}
    t0 = time.perf_counter()
    while True:
        i = len(ran) % len(pool)
        last[i] = embedder.embed_ids(*pool[i])
        ran.append(i)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    host = ctx.host_load(window_s)
    peak = ctx.peak_memory()
    done = sum(len(pool[i][0]) for i in ran)
    per_batch = {i: flops_moe.embed_text(cell.config, pool[i][1].sum(1))
                 for i in last}

    stretch = None
    if ctx.trace:
        traced = [(len(ran) + k) % len(pool)
                  for k in range(cell.mix["trace_batches"])]
        layers, counters = _moe_layers(embedder.model), []
        with ctx.stretch() as s:
            for i in traced:
                embedder.embed_ids(*pool[i])
                counters.append([m.expert_rows for m in layers])
        stretch = {"window_s": s.window_s, "events": s.events,
                   "steps": len(traced), "attention": [],
                   "expert_rows": [[c.tolist() for c in batch]
                                   for batch in counters if batch]}

    rows = [(i, r) for i in sorted(last) for r in range(len(pool[i][0]))]
    rng = np.random.default_rng(traffic.sub_seed(ctx.seed, "sample"))
    picked = [rows[j] for j in embedding.sample(
        rng, [int(pool[i][1][r].sum()) for i, r in rows], cell.mix["sample"])]
    ids = np.stack([pool[i][0][r] for i, r in picked])
    mask = np.stack([pool[i][1][r] for i, r in picked])
    answers = np.stack([last[i][r] for i, r in picked])
    prog_routes = _program_routes(embedder, ids, mask)
    del embedder, pool, last
    ctx.free()
    phases.skip()
    ref_emb, ref_routes = reference(torch, cell.config, ctx.seed, ids, mask,
                                    device)
    phases.mark("reference")
    numbers = {"embedding_gap": embedding.embedding_gap(answers, ref_emb),
               "route_flip_share": flip_share(prog_routes, ref_routes, mask)}
    return {
        "attempted": done, "failed": 0,
        "end_to_end": {"embed_clips_per_s": done / window_s},
        "readings": numbers,
        "memory_peak_bytes": peak,
        "window": {"seconds": window_s, "steps": len(ran), "clips": done,
                   "model_flops": sum(per_batch[i] for i in ran)},
        "stretch": stretch,
        "report": {"checked": len(picked), "host": host},
        "notes": [phases.note()],
    }
