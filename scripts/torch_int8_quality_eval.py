#!/usr/bin/env python
"""Int8 end-task accuracy against full precision on a trained checkpoint of
the PyTorch port: the port of ``scripts/int8_quality_eval.py``.

Loads a port checkpoint (default: the best-gap model of
``runs/torch_parity16_s42``, written by ``scripts/torch_proxy_quality_run.py``),
embeds the test split of the checkpoint's own corpus both in full precision
and int8-quantized (W8A8 on every Dense of the pair forward,
``Embedder.quantize_int8``: the ``serve --int8`` configuration), and
reports for both:

  * speech→text retrieval Recall@1/5/10, MRR and mean rank over the test
    pool, and
  * the clean-vs-corrupt similarity gap in the sigmoid(cos/τ) readout, with
    the same corrupted negatives for both precisions and the same strings
    as the JAX script draws (``SeedSequence([seed, 2, i])`` per clip), so
    the comparison isolates quantization.

Writes ``<checkpoint_dir>/../int8_quality_eval.json`` (the JAX script's
keys: ``checkpoint``, ``pool``, ``fp``, ``int8``, ``delta_int8_minus_fp``)
and prints a table. ``--device`` defaults to ``cuda`` (int8 products on
``torch._int_mm``); ``cuda`` without a card raises, ``cpu`` runs the plain
int32 products:

    python scripts/torch_int8_quality_eval.py \\
        --checkpoint runs/torch_parity16_s42/best_model_gap
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def embed_split(emb, texts, audios, chunk=32):
    te = np.concatenate([emb.embed_texts(texts[i:i + chunk])
                         for i in range(0, len(texts), chunk)])
    ae = np.concatenate([emb.embed_audios(audios[i:i + chunk])
                         for i in range(0, len(audios), chunk)])
    return te, ae


def evaluate(emb, texts, corrupts, audios, temperature):
    from speech_transcript_embeddings_torch.inference.embed import (
        retrieval_metrics,
    )

    te, ae = embed_split(emb, texts, audios)
    tn = np.concatenate([emb.embed_texts(corrupts[i:i + 32])
                         for i in range(0, len(corrupts), 32)])
    s_pos = np.sum(te * ae, axis=1)
    s_neg = np.sum(tn * ae, axis=1)
    hr = lambda s: 1.0 / (1.0 + np.exp(-s / temperature))  # noqa: E731
    out = retrieval_metrics(ae, te)
    out.update({
        "clean_similarity": float(hr(s_pos).mean()),
        "corrupt_similarity": float(hr(s_neg).mean()),
        "similarity_gap": float(hr(s_pos).mean() - hr(s_neg).mean()),
        "clean_cos": float(s_pos.mean()),
        "corrupt_cos": float(s_neg.mean()),
    })
    return out


def eval_pool(cfg, limit=0):
    """The first ``limit`` (0: all) clips of the test split of the
    checkpoint's corpus → (texts, audios, corrupted texts). Each negative
    is drawn from its own ``SeedSequence([seed, 2, i])``: the JAX script's
    strings, and the same for both precisions."""
    from speech_transcript_embeddings_torch.data import (
        create_corrupted_transcript, make_source,
    )
    source = make_source(cfg.data, seed=cfg.train.seed)
    n = source.num_examples("test")
    if limit:
        n = min(n, limit)
    texts, audios, corrupts = [], [], []
    for i in range(n):
        ex = source.example_at("test", i)
        texts.append(ex.sentence)
        audios.append(ex.audio)
        corrupts.append(create_corrupted_transcript(
            ex.sentence, np.random.default_rng(
                np.random.SeedSequence([cfg.train.seed, 2, i]))))
    return texts, audios, corrupts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--checkpoint",
                    default="runs/torch_parity16_s42/best_model_gap")
    ap.add_argument("--limit", type=int, default=0,
                    help="cap the test pool (0 = full split)")
    ap.add_argument("--out", default=None,
                    help="output JSON (default <ckpt>/../int8_quality_eval.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cuda without a card "
                         "raises)")
    args = ap.parse_args(argv)

    from speech_transcript_embeddings_torch.inference.embed import Embedder

    emb = Embedder.from_checkpoint(args.checkpoint, device=args.device)
    cfg = emb.cfg
    texts, audios, corrupts = eval_pool(cfg, args.limit)
    n = len(texts)
    print(f"test pool: {n} clips (checkpoint {args.checkpoint})", flush=True)

    fp = evaluate(emb, texts, corrupts, audios, cfg.loss.temperature)
    print("fp  :", json.dumps(fp), flush=True)
    del emb

    emb_q = Embedder.from_checkpoint(args.checkpoint,
                                     device=args.device).quantize_int8()
    q = evaluate(emb_q, texts, corrupts, audios, cfg.loss.temperature)
    print("int8:", json.dumps(q), flush=True)

    delta = {k: round(q[k] - fp[k], 6) for k in fp}
    result = {"checkpoint": args.checkpoint, "pool": n,
              "fp": fp, "int8": q, "delta_int8_minus_fp": delta}
    out_path = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.checkpoint)),
        "int8_quality_eval.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)

    print(f"\n{'metric':<22}{'fp':>12}{'int8':>12}{'delta':>12}")
    for k in ("recall@1", "recall@5", "recall@10", "mrr", "mean_rank",
              "similarity_gap", "clean_similarity", "corrupt_similarity"):
        print(f"{k:<22}{fp[k]:>12.4f}{q[k]:>12.4f}{q[k] - fp[k]:>12.4f}")
    print(f"\nwritten: {out_path}")
    return result


if __name__ == "__main__":
    main()
