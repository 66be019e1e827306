"""Inference CLI of the port: single-pair and batch similarity scoring.

``python -m speech_transcript_embeddings_torch.infer pair --checkpoint DIR \\
      --audio clip.wav --text "..." [--device cuda|cpu]``
    prints the pair forward's similarity (cross-modal fusion included when
    the model fuses) and the projection-path similarity, and saves a bar
    chart of the two.

``python -m speech_transcript_embeddings_torch.infer batch --checkpoint DIR \\
      [--num-samples N] [--dataset synthetic|common_voice|local]``
    scores the test split: writes ``cv_results/cv_similarities.csv``
    (``sample_id,text,similarity,projection_similarity``) and the bar
    charts, prints the top-3 table and speech→text Recall@K over the scored
    set.

Port of ``speech_transcript_embeddings_tpu/infer.py``. ``--device``
defaults to ``cuda``; ``cuda`` without a card raises. ``--int8`` scores
with int8 (W8A8) Dense products (``Embedder.quantize_int8``).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os

import numpy as np

from speech_transcript_embeddings_torch.data import make_source
from speech_transcript_embeddings_torch.data.sources import (
    synth_audio_for_sentence,
)
from speech_transcript_embeddings_torch.inference.embed import (
    Embedder, retrieval_metrics,
)

_BATCH = 32     # clips per call: bounds the padded audio in memory


def _load_audio(path: str) -> np.ndarray:
    """A 16 kHz clip from a file (WAV natively, mp3/ogg/flac through
    soundfile or ffmpeg), or ``synthetic:<sentence>``."""
    if path.startswith("synthetic:"):
        return synth_audio_for_sentence(path.split(":", 1)[1])
    from speech_transcript_embeddings_torch.data import native_audio
    with open(path, "rb") as f:
        wav, sr = native_audio.decode_audio(f.read(), path)
    if sr != 16000:
        wav = native_audio.resample(wav, sr, 16000)
    return np.asarray(wav, np.float32)


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _bar_chart(values, labels, title, path):
    plt = _plt()
    if plt is None:
        return
    plt.figure(figsize=(8, 4))
    plt.bar(range(len(values)), values,
            color=["#3498db", "#e74c3c"][: len(values)], width=0.4)
    plt.xticks(range(len(values)), labels)
    plt.title(title)
    plt.ylabel("Cosine Similarity")
    plt.ylim(-1, 1)
    for i, v in enumerate(values):
        plt.text(i, v / 2, f"{v:.4f}", ha="center", va="center",
                 fontweight="bold", color="white", fontsize=12)
    plt.grid(axis="y", linestyle="--", alpha=0.7)
    plt.tight_layout()
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()


def _embedder(args) -> Embedder:
    emb = Embedder.from_checkpoint(args.checkpoint, device=args.device)
    return emb.quantize_int8() if args.int8 else emb


def run_pair(args) -> float:
    emb = _embedder(args)
    audio = _load_audio(args.audio)
    print("=" * 60)
    print("Audio-Text Similarity Inference")
    print("=" * 60)
    sim_fused, _, _ = emb.embed_pair(args.text, audio)
    text_e = emb.embed_texts([args.text])[0]
    audio_e = emb.embed_audios([audio])[0]
    sim_proj = float(np.sum(text_e * audio_e))
    print(f"Similarity score (fused forward): {sim_fused:.4f}")
    print(f"Similarity score (projection path): {sim_proj:.4f}")
    _bar_chart([sim_fused, sim_proj], ["Fused forward", "Projection path"],
               "Text-Audio Similarity",
               args.output or "similarity_comparison.png")
    return sim_fused


def run_batch(args) -> dict:
    emb = _embedder(args)
    data_cfg = emb.cfg.data
    if args.dataset:
        data_cfg = dataclasses.replace(data_cfg, dataset=args.dataset)
    source = make_source(data_cfg, seed=emb.cfg.train.seed)
    os.makedirs(args.results_dir, exist_ok=True)

    audios, texts = [], []
    for i, ex in enumerate(source.examples("test")):
        if args.num_samples and i >= args.num_samples:
            break
        audios.append(ex.audio)
        texts.append(ex.sentence)
    print(f"Scoring {len(texts)} test samples...")
    chunks = range(0, len(texts), _BATCH)
    text_embs = emb.embed_texts(texts)
    audio_embs = np.concatenate([emb.embed_audios(audios[i:i + _BATCH])
                                 for i in chunks])
    proj_sims = np.sum(text_embs * audio_embs, axis=1)
    # the reference's two scores: the pair forward's similarity is the CSV's
    # main score, the projection path's rides beside it
    sims = np.concatenate([emb.pair_similarities(texts[i:i + _BATCH],
                                                 audios[i:i + _BATCH])
                           for i in chunks])

    rows = []
    for i, (t, s, ps) in enumerate(zip(texts, sims, proj_sims)):
        rows.append({"sample_id": str(i), "text": t, "similarity": float(s),
                     "projection_similarity": float(ps)})
        if args.per_sample_plots:
            _bar_chart([float(s), float(ps)],
                       ["Fused forward", "Projection path"],
                       f"Sample {i + 1}: Text-Audio Similarity",
                       os.path.join(args.results_dir,
                                    f"sample_{i + 1}_similarity.png"))
    csv_path = os.path.join(args.results_dir, "cv_similarities.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["sample_id", "text", "similarity",
                                          "projection_similarity"])
        w.writeheader()
        w.writerows(rows)

    print("=" * 60)
    print("Results Summary")
    print("=" * 60)
    print(f"Processed {len(rows)} samples")
    print(f"Average similarity (fused forward): {sims.mean():.4f}")
    print(f"Average similarity (projection path): {proj_sims.mean():.4f}")
    print(f"Min similarity: {sims.min():.4f}")
    print(f"Max similarity: {sims.max():.4f}")
    print("\nTop 3 samples by similarity:")
    for rank, i in enumerate(np.argsort(-sims)[:3], 1):
        t = texts[i]
        print(f"  {rank}. {sims[i]:.4f} - \"{t[:50]}"
              f"{'...' if len(t) > 50 else ''}\"")
    rm = retrieval_metrics(audio_embs, text_embs)
    print("\nSpeech→text retrieval over the scored set:")
    for k, v in rm.items():
        print(f"  {k}: {v:.4f}")

    plt = _plt()
    if plt is not None:
        plt.figure(figsize=(12, 6))
        plt.bar(range(len(sims)), sims, color="#3498db")
        plt.xlabel("Sample Number")
        plt.ylabel("Similarity Score")
        plt.title("Similarity Scores for Test Samples")
        plt.ylim(-1, 1)
        plt.grid(axis="y", linestyle="--", alpha=0.7)
        plt.tight_layout()
        plt.savefig(os.path.join(args.results_dir, "all_similarities.png"),
                    dpi=150)
        plt.close()
    print(f"\nResults saved to: {csv_path}")
    return {"similarities": sims, "projection_similarities": proj_sims,
            "text_embeddings": text_embs, "audio_embeddings": audio_embs,
            "retrieval": rm, "csv": csv_path}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Speech-transcript similarity inference")
    sub = parser.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("pair", help="score one audio/text pair")
    p.add_argument("--audio", required=True,
                   help="wav path or synthetic:<sentence>")
    p.add_argument("--text", required=True)
    p.add_argument("--output", default=None)
    b = sub.add_parser("batch", help="score the test split")
    b.add_argument("--num-samples", type=int, default=10)
    b.add_argument("--dataset", default=None,
                   choices=[None, "synthetic", "common_voice", "local"])
    b.add_argument("--results-dir", default="cv_results")
    b.add_argument("--per-sample-plots", action="store_true")
    for s in (p, b):
        s.add_argument("--checkpoint", required=True)
        s.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu; cuda without a card "
                            "raises")
        s.add_argument("--int8", action="store_true",
                       help="int8 (W8A8) Dense products")
    args = parser.parse_args(argv)
    return run_pair(args) if args.mode == "pair" else run_batch(args)


if __name__ == "__main__":
    main()
