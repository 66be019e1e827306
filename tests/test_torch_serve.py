"""The port's HTTP service over a real socket, on the CPU (as
tests/test_serve.py drives the JAX one): a seeded tiny retrieval model saved
as a port checkpoint, served by ``speech_transcript_embeddings_torch.serve``
with the JAX package's MicroBatcher and handler."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from speech_transcript_embeddings_tpu.config import (
    DataConfig, ExperimentConfig, tiny_model_config,
)
from speech_transcript_embeddings_tpu.data.sources import (
    synth_audio_for_sentence,
)
from speech_transcript_embeddings_torch import checkpoints
from speech_transcript_embeddings_torch.models.dual_encoder import init_model
from speech_transcript_embeddings_torch.serve import (
    EmbeddingService, main, make_handler,
)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    mc = tiny_model_config(use_word_alignment=False)
    mc = dataclasses.replace(
        mc, heads=dataclasses.replace(mc.heads, use_cross_modal=False),
        audio=dataclasses.replace(mc.audio, use_flash_attention=True),
        frontend=dataclasses.replace(mc.frontend, use_pallas=True))
    cfg = ExperimentConfig(model=mc, data=DataConfig(
        dataset="synthetic", max_text_length=12,
        audio_buckets=(16000, 48000), max_audio_samples=48000))
    path = str(tmp_path_factory.mktemp("torch_serve") / "model")
    checkpoints.save_checkpoint(
        path, init_model(mc, torch.Generator().manual_seed(0)), cfg)
    return path


@pytest.fixture(scope="module")
def server(ckpt):
    service = EmbeddingService(ckpt, device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}", service
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_healthz(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        data = json.loads(r.read())
    assert data == {"status": "ok", "projection_dim": 24}


def test_embed_and_similarity(server):
    url, service = server
    status, out = _post(url + "/embed_text", {"texts": ["casa tempo", "mar sol"]})
    embs = np.asarray(out["embeddings"])
    assert status == 200 and embs.shape == (2, 24)
    np.testing.assert_allclose(np.linalg.norm(embs, axis=1), 1.0, rtol=1e-5)

    audio = synth_audio_for_sentence("casa tempo")
    long_clip = np.concatenate([audio] * 3)          # the 48000 bucket
    status, out = _post(url + "/embed_audio",
                        {"audios": [audio.tolist(), long_clip.tolist()]})
    embs = np.asarray(out["embeddings"])
    assert status == 200 and embs.shape == (2, 24) and np.isfinite(embs).all()
    alone = service.embedder.embed_audios([audio])[0]
    assert np.dot(alone, embs[0]) > 0.999      # batching does not change it

    status, out = _post(url + "/similarity",
                        {"text": "casa tempo", "audio": audio.tolist()})
    assert status == 200
    assert -1 <= out["similarity"] <= 1
    assert abs(out["similarity"] - out["similarity_fused"]) < 1e-5


def test_concurrent_http_clients(server):
    url, _ = server
    out = [None] * 6

    def client(i):
        out[i] = _post(url + "/embed_text", {"texts": [f"casa {i}", "tempo"]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for status, payload in out:
        assert status == 200
        assert np.asarray(payload["embeddings"]).shape == (2, 24)


def test_bad_requests_and_stats(server):
    url, _ = server
    for path, payload in (("/embed_text", {}), ("/embed_audio", {"audios": []}),
                          ("/similarity", {"text": "x"})):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + path, payload)
        assert e.value.code == 400
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["text"]["requests"] >= 1 and stats["audio"]["dispatches"] >= 1


def test_int8_and_missing_card_raise(ckpt, monkeypatch):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        main(["--checkpoint", ckpt, "--device", "cpu", "--int8"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingService(ckpt, device="cuda")
