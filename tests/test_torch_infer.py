"""The port's inference CLI (``speech_transcript_embeddings_torch.infer``)
on a tiny fused checkpoint: ``pair`` and ``batch`` write the JAX CLI's
outputs (the CSV header and one row per scored clip), and the fused
``pair_similarities`` and the Recall@K block equal the JAX ``Embedder``'s
on the same weights within 1e-5."""

import csv

import numpy as np
import pytest
import torch

from speech_transcript_embeddings_tpu.config import (
    DataConfig, ExperimentConfig, tiny_model_config,
)
from speech_transcript_embeddings_tpu.data.sources import make_source
from speech_transcript_embeddings_tpu.inference import embed as jembed
from speech_transcript_embeddings_torch import bridge, checkpoints, infer
from speech_transcript_embeddings_torch.models.dual_encoder import init_model
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

N = 12


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = ExperimentConfig(
        model=tiny_model_config(),
        data=DataConfig(dataset="synthetic", max_text_length=12,
                        audio_buckets=(16000, 48000), max_audio_samples=48000,
                        num_synthetic_samples=4 * N))
    model = init_model(port_cfg(cfg.model), torch.Generator().manual_seed(3))
    path = str(tmp_path_factory.mktemp("torch_infer") / "model")
    checkpoints.save_params_checkpoint(path, model, port_cfg(cfg))
    ref = jembed.Embedder(cfg, bridge.state_dict_to_flax(model, cfg.model))
    return path, cfg, ref


def test_batch_writes_the_csv_and_matches_jax(ckpt, tmp_path, capsys):
    path, cfg, ref = ckpt
    out = infer.main(["batch", "--checkpoint", path, "--device", "cpu",
                      "--num-samples", str(N),
                      "--results-dir", str(tmp_path / "cv")])
    with open(out["csv"], newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["sample_id", "text", "similarity",
                       "projection_similarity"]
    assert len(rows) == N + 1 and [r[0] for r in rows[1:]] == \
        [str(i) for i in range(N)]
    assert (tmp_path / "cv" / "all_similarities.png").exists()
    printed = capsys.readouterr().out
    assert "recall@1" in printed and f"Processed {N} samples" in printed
    # the same test clips through the JAX Embedder on the same weights
    examples = list(make_source(cfg.data, seed=cfg.train.seed)
                    .examples("test"))[:N]
    texts = [e.sentence for e in examples]
    audios = [e.audio for e in examples]
    np.testing.assert_allclose(out["similarities"],
                               ref.pair_similarities(texts, audios),
                               rtol=1e-5, atol=1e-5)
    t, a = ref.embed_texts(texts), ref.embed_audios(audios)
    np.testing.assert_allclose(out["projection_similarities"],
                               np.sum(t * a, axis=1), rtol=1e-5, atol=1e-5)
    want = jembed.retrieval_metrics(a, t)
    assert out["retrieval"].keys() == want.keys()
    for k in want:
        assert out["retrieval"][k] == pytest.approx(want[k], abs=1e-5), k
    # the fusion ran: the pair scores are not the projection-path scores
    assert np.abs(out["similarities"] - out["projection_similarities"]
                  ).max() > 1e-3
    # and row i of the CSV holds sample i's two scores
    assert float(rows[1][2]) == pytest.approx(float(out["similarities"][0]))


def test_pair_prints_both_scores_and_matches_jax(ckpt, tmp_path, capsys):
    path, cfg, ref = ckpt
    sentence = "casa tempo dia noite"
    sim = infer.main(["pair", "--checkpoint", path, "--device", "cpu",
                      "--audio", f"synthetic:{sentence}", "--text", sentence,
                      "--output", str(tmp_path / "pair.png")])
    printed = capsys.readouterr().out
    assert "(fused forward)" in printed and "(projection path)" in printed
    assert (tmp_path / "pair.png").exists()
    from speech_transcript_embeddings_tpu.data.sources import (
        synth_audio_for_sentence,
    )
    rsim, _, _ = ref.embed_pair(sentence, synth_audio_for_sentence(sentence))
    assert sim == pytest.approx(rsim, abs=1e-5)


@pytest.mark.parametrize("argv,error", [
    (["--device", "cpu", "--int8"], None),
    ([], RuntimeError),
], ids=["int8", "cuda_without_a_card"])
def test_int8_and_a_missing_card_raise(ckpt, tmp_path, argv, error):
    """``--int8`` scores the batch with int8 Dense products and writes the
    CSV in its schema; ``cuda`` (the default) without a card raises."""
    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["batch", "--checkpoint", ckpt[0], "--num-samples", "4",
            "--results-dir", str(tmp_path)] + argv
    if error is not None:
        with pytest.raises(error):
            infer.main(argv)
        return
    out = infer.main(argv)
    with open(out["csv"], newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["sample_id", "text", "similarity",
                       "projection_similarity"] and len(rows) == 5
    sims = np.asarray([[float(r[2]), float(r[3])] for r in rows[1:]])
    assert np.isfinite(sims).all() and np.abs(sims).max() <= 1.0 + 1e-6


def test_pair_similarities_pads_rows_like_embed_audios(ckpt):
    """Three pairs are padded to a row bucket of four; each pair's score
    equals its score alone."""
    path, cfg, ref = ckpt
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    emb = Embedder.from_checkpoint(path, device="cpu")
    rng = np.random.default_rng(0)
    audios = [rng.normal(scale=0.2, size=n).astype(np.float32)
              for n in (9000, 15000, 12000)]
    texts = ["casa tempo", "mar sol dia", "uma palavra"]
    together = emb.pair_similarities(texts, audios)
    alone = [emb.embed_pair(t, a)[0] for t, a in zip(texts, audios)]
    np.testing.assert_allclose(together, alone, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="texts for"):
        emb.pair_similarities(texts, audios[:2])
