"""The slice end to end: the port's ``Embedder`` against the JAX
``Embedder`` on bridged params (tiny retrieval config, fp32, with the
Pallas frontend and flash attention on — interpret mode in JAX, the plain
twins in the port), across two audio buckets; port checkpoints;
``retrieval_metrics``; and the import rule (no jax in the port)."""

import dataclasses
import subprocess
import sys
import os

import numpy as np
import pytest
import jax
import torch

from speech_transcript_embeddings_tpu.config import (
    DataConfig, ExperimentConfig, tiny_model_config,
)
from speech_transcript_embeddings_tpu.inference import embed as jembed
from speech_transcript_embeddings_tpu.models.dual_encoder import (
    DualEncoderModel as JaxModel, init_params,
)
from speech_transcript_embeddings_torch import bridge, checkpoints
from speech_transcript_embeddings_torch.inference import embed as tembed
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel,
)
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
TEXTS = ["casa tempo dia", "mar sol", "uma palavra longa de teste aqui"]


def _cfg():
    mc = tiny_model_config(use_word_alignment=False)
    mc = dataclasses.replace(
        mc, heads=dataclasses.replace(mc.heads, use_cross_modal=False),
        audio=dataclasses.replace(mc.audio, use_flash_attention=True),
        frontend=dataclasses.replace(mc.frontend, use_pallas=True))
    return ExperimentConfig(
        model=mc, data=DataConfig(dataset="synthetic", max_text_length=12,
                                  audio_buckets=(16000, 48000),
                                  max_audio_samples=48000))


def _clips(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=0.2, size=n).astype(np.float32) for n in lengths]


@pytest.fixture(scope="module")
def pair():
    cfg = _cfg()
    params = init_params(JaxModel(cfg.model), jax.random.PRNGKey(0))
    ref = jembed.Embedder(cfg, params)
    model = bridge.load_flax_params(DualEncoderModel(port_cfg(cfg.model)),
                                    jax.tree.map(np.asarray, params))
    return ref, tembed.Embedder(port_cfg(cfg), model)


def test_embed_texts_matches_jax(pair):
    ref, port = pair
    got = port.embed_texts(TEXTS)
    assert got.shape == (3, 24)
    np.testing.assert_allclose(got, ref.embed_texts(TEXTS), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("lengths", [(9000, 15000, 300), (20000, 40000)],
                         ids=["bucket_16000", "bucket_48000"])
def test_embed_audios_matches_jax(pair, lengths):
    ref, port = pair
    clips = _clips(lengths, seed=len(lengths))
    clips[0] = clips[0] * 20.0            # peak > 1: normalised by the peak
    got = port.embed_audios(clips)
    assert got.shape == (len(lengths), 24) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.embed_audios(clips), **TOL)


def test_embed_pair_matches_jax(pair):
    ref, port = pair
    clip = _clips([30000], seed=5)[0]
    sim, te, ae = port.embed_pair(TEXTS[0], clip)
    rsim, rte, rae = ref.embed_pair(TEXTS[0], clip)
    np.testing.assert_allclose(te, rte, **TOL)
    np.testing.assert_allclose(ae, rae, **TOL)
    assert abs(sim - rsim) < 1e-4
    np.testing.assert_allclose(port.similarity(te, ae), sim, rtol=1e-5)


def test_checkpoint_round_trip(pair, tmp_path):
    _, port = pair
    path = str(tmp_path / "ckpt")
    checkpoints.save_params_checkpoint(path, port.model, port.cfg, info={"seed": 0})
    meta = checkpoints.load_metadata(path)
    assert meta["kind"] == "torch_params" and meta["format_version"] == 1
    assert meta["info"] == {"seed": 0}
    loaded = tembed.Embedder.from_checkpoint(path, device="cpu")
    assert loaded.cfg == port.cfg
    np.testing.assert_array_equal(loaded.embed_texts(TEXTS),
                                  port.embed_texts(TEXTS))


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tembed.resolve_device("cuda")
    assert tembed.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(64, 16)).astype(np.float32)
    t = a + rng.normal(scale=1.5, size=a.shape).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    assert (tembed.retrieval_metrics(a, t, ks=(1, 5, 10))
            == jembed.retrieval_metrics(a, t, ks=(1, 5, 10)))


def test_port_imports_without_jax():
    """The card's machine has no jax, and the port imports nothing of the
    JAX package: every entry point (conversion included), both kernel
    modules and the int8 products import with jax,
    flax, optax, orbax and speech_transcript_embeddings_tpu blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'orbax', "
            "'speech_transcript_embeddings_tpu'): sys.modules[m] = None\n"
            "import speech_transcript_embeddings_torch.serve\n"
            "import speech_transcript_embeddings_torch.train\n"
            "import speech_transcript_embeddings_torch.training.loop\n"
            "from speech_transcript_embeddings_torch.inference.embed import Embedder\n"
            "import speech_transcript_embeddings_torch.bridge\n"
            "import speech_transcript_embeddings_torch.ops.frontend_kernels\n"
            "import speech_transcript_embeddings_torch.ops.flash_attention\n"
            "import speech_transcript_embeddings_torch.data.native_audio\n"
            "import speech_transcript_embeddings_torch.infer\n"
            "import speech_transcript_embeddings_torch.convert_checkpoint\n"
            "import speech_transcript_embeddings_torch.models.ingest_torch\n"
            "import speech_transcript_embeddings_torch.ops.quant\n"
            "import speech_transcript_embeddings_torch.utils.env\n"
            "assert not any(k.split('.')[0] in ('jax', 'flax', "
            "'speech_transcript_embeddings_tpu') "
            "for k, v in sys.modules.items() if v is not None)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
