"""The port's own copies of the JAX package's framework-free modules (config,
data pipeline, tokenizers, the HTTP handler) against the originals: the
same values, batches, token ids and JSON, so that the port can drop every
import of the JAX package without changing what it computes."""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from speech_transcript_embeddings_tpu import config as jconfig
from speech_transcript_embeddings_tpu import serve as jserve
from speech_transcript_embeddings_tpu.data import pipeline as jpipeline
from speech_transcript_embeddings_tpu.data import sources as jsources
from speech_transcript_embeddings_tpu.data import tokenizers as jtokenizers
from speech_transcript_embeddings_torch import checkpoints
from speech_transcript_embeddings_torch import config as tconfig
from speech_transcript_embeddings_torch import data as tdata
from speech_transcript_embeddings_torch import serve as tserve
from speech_transcript_embeddings_torch.models.dual_encoder import init_model
from torch_port_cfg import one_thread  # noqa: F401

PRESETS = ["tiny_model_config", "retrieval_model_config",
           "roberta_model_config", "flagship_model_config",
           "ExperimentConfig", "MeshConfig", "TrainConfig", "DataConfig"]


@pytest.mark.parametrize("name", PRESETS)
def test_config_presets_match_jax(name):
    """Each preset and default of the port's config has the JAX package's
    fields and values, and a config round-trips through the other
    package's JSON (a checkpoint's metadata.json reads the same in both)."""
    port, ref = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert type(port).__module__ == "speech_transcript_embeddings_torch.config"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if name == "ExperimentConfig":
        assert dataclasses.asdict(tconfig.ExperimentConfig.from_json(
            ref.to_json())) == dataclasses.asdict(ref)
        assert port.to_json() == ref.to_json()


OVERRIDES = [
    ["train.num_epochs=3", "loss.kind=global"],
    ["data.audio_buckets=[48000, 96000]", "model.audio.remat_policy=save_hot2",
     "optimizer.learning_rate=0.0003"],
    ["freeze.frozen_dtype=bfloat16", "model.dtype=float32",
     "data.dataset=synthetic", "train.output_dir=runs/x"],
]


@pytest.mark.parametrize("argv", OVERRIDES, ids=["ints", "lists", "strings"])
def test_parse_overrides_match_jax(argv):
    assert tconfig.parse_overrides(argv) == jconfig.parse_overrides(argv)
    port = tconfig.ExperimentConfig().with_overrides(
        tconfig.parse_overrides(argv))
    ref = jconfig.ExperimentConfig().with_overrides(
        jconfig.parse_overrides(argv))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("seed", [0, 7])
def test_pipeline_epoch_batches_match_jax(seed):
    """``DataPipeline.epoch_batches`` over ``SyntheticSource``: the same
    batches, key by key and bit for bit, for two seeds."""
    kw = dict(dataset="synthetic", batch_size=4, max_text_length=12,
              audio_buckets=(16000, 48000), max_audio_samples=48000,
              num_synthetic_samples=24)
    got, want = [], []
    for lib, cfgs, out in ((tdata, tconfig, got),
                           (jpipeline, jconfig, want)):
        cfg = cfgs.DataConfig(**kw)
        src = (tdata.SyntheticSource if lib is tdata
               else jsources.SyntheticSource)(cfg, seed=seed + 3)
        tok = (tdata.SimpleWordTokenizer if lib is tdata
               else jtokenizers.SimpleWordTokenizer)(vocab_size=128)
        pipe = lib.DataPipeline(cfg, tok, seed=seed)
        for split in ("train", "validation"):
            out.extend(pipe.epoch_batches(src, split, epoch=1))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)


@pytest.mark.parametrize("text,max_length", [
    ("uma frase de teste", 12), ("casa", 4), ("", 8),
    ("a cidade dorme sob a chuva fina da noite de inverno", 6)])
def test_tokenizers_give_the_same_ids(text, max_length):
    port = tdata.SimpleWordTokenizer(vocab_size=1000)
    ref = jtokenizers.SimpleWordTokenizer(vocab_size=1000)
    for a, b in zip(port.encode(text, max_length),
                    ref.encode(text, max_length)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's service on the CPU behind the port's handler and behind
    the JAX package's ``make_handler``."""
    mc = tconfig.tiny_model_config(use_word_alignment=False)
    mc = dataclasses.replace(
        mc, heads=dataclasses.replace(mc.heads, use_cross_modal=False))
    cfg = tconfig.ExperimentConfig(model=mc, data=tconfig.DataConfig(
        dataset="synthetic", max_text_length=12, audio_buckets=(16000,),
        max_audio_samples=16000))
    path = str(tmp_path_factory.mktemp("port_copies") / "model")
    checkpoints.save_params_checkpoint(
        path, init_model(mc, torch.Generator().manual_seed(0)), cfg)
    service = tserve.EmbeddingService(path, device="cpu")
    urls, stops = [], []
    for make in (tserve.make_handler, jserve.make_handler):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make(service))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        urls.append(f"http://127.0.0.1:{httpd.server_port}")
        stops.append((httpd, thread))
    yield urls
    for httpd, thread in stops:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def _call(url, payload):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


@pytest.mark.parametrize("path,payload", [
    ("/embed_text", {"texts": ["casa tempo dia", "mar sol"]}),
    ("/embed_text", {"texts": []}),
    ("/embed_text", {"text": "no list"}),
    ("/unknown", {"texts": ["x"]}),
    ("/healthz", None)],
    ids=["two_texts", "empty_list", "missing_field", "unknown_path",
         "healthz"])
def test_handlers_return_the_same_json(servers, path, payload):
    port, ref = (_call(url + path, payload) for url in servers)
    assert port == ref
    if port[0] == 200 and path == "/embed_text":
        e = np.asarray(port[1]["embeddings"])
        assert e.shape == (2, 24)
        np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1, atol=1e-5)


DOTENV = """# a comment
export HF_TOKEN='hf_abc'
STE_CV_LOCAL_DATASET_DIR = "/data/cv pt"
EMPTY=
no_equals_sign
STE_SHELL_WINS=from_file
"""


def test_load_dotenv_matches_jax(tmp_path, monkeypatch):
    """The port's ``utils/env.py`` parses the same ``.env`` text to the same
    dict and leaves the same environment, a variable set in the shell
    winning over the file in both."""
    from speech_transcript_embeddings_tpu.utils import env as jenv
    from speech_transcript_embeddings_torch.utils import env as tenv
    path = tmp_path / ".env"
    path.write_text(DOTENV)
    seen = []
    for load in (jenv.load_dotenv, tenv.load_dotenv):
        for key in ("HF_TOKEN", "STE_CV_LOCAL_DATASET_DIR", "EMPTY"):
            monkeypatch.delenv(key, raising=False)
        monkeypatch.setenv("STE_SHELL_WINS", "from_shell")
        parsed = load(str(path))
        seen.append((parsed, {k: os.environ.get(k) for k in parsed}))
    assert seen[0] == seen[1]
    assert seen[1][1] == {"HF_TOKEN": "hf_abc",
                          "STE_CV_LOCAL_DATASET_DIR": "/data/cv pt",
                          "EMPTY": "", "STE_SHELL_WINS": "from_shell"}
    assert tenv.load_dotenv(str(tmp_path / "missing.env")) == {}
