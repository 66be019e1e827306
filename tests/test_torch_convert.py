"""The port's HF conversion (``models/convert.py``, ``convert_checkpoint.py``)
against the JAX package's converter and against the HF models themselves:
tiny random ``XLMRobertaModel`` and ``Wav2Vec2BertModel`` built from
configs (no download), as tests/test_encoders.py builds them. The renamed
state dicts equal JAX's converted trees carried through
``bridge.flax_to_state_dict`` exactly, prefixed exports included; the
port's encoders on them match the HF forward at rtol 1e-3 / atol 3e-4
(tests/test_encoders.py's tolerance); the configs read from HF equal
JAX's; and the CLI's HF path writes a checkpoint that serving and
``train.init_checkpoint`` load."""

import numpy as np
import pytest
import torch

from speech_transcript_embeddings_tpu.models import convert as jconvert
from speech_transcript_embeddings_torch import bridge, checkpoints
from speech_transcript_embeddings_torch import convert_checkpoint
from speech_transcript_embeddings_torch.config import HeadsConfig
from speech_transcript_embeddings_torch.inference.embed import Embedder
from speech_transcript_embeddings_torch.models import convert
from speech_transcript_embeddings_torch.models.dual_encoder import init_model
from speech_transcript_embeddings_torch.training import loop
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401

HEADS = HeadsConfig(projection_dim=24, dropout=0.0, cross_modal_heads=4,
                    alignment_heads=2)


@pytest.fixture(scope="module")
def hf():
    from transformers import (
        Wav2Vec2BertConfig, Wav2Vec2BertModel, XLMRobertaConfig,
        XLMRobertaModel,
    )
    torch.manual_seed(0)
    text = XLMRobertaModel(XLMRobertaConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=48, type_vocab_size=1, pad_token_id=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        add_pooling_layer=False).eval()
    # SpecAugment on: the export carries masked_spec_embed
    audio = Wav2Vec2BertModel(Wav2Vec2BertConfig(
        feature_projection_input_dim=16, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        conv_depthwise_kernel_size=7, left_max_position_embeddings=8,
        right_max_position_embeddings=2, hidden_dropout=0.0,
        attention_dropout=0.0, conformer_conv_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
        mask_time_prob=0.05, mask_feature_prob=0.0,
        apply_spec_augment=True)).eval()
    return text, audio


def _np(model, prefix=""):
    return {prefix + k: v.detach().numpy()
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("prefixed", [False, True], ids=["plain", "prefixed"])
def test_state_dicts_equal_the_jax_converter_through_the_bridge(hf, prefixed):
    text, audio = hf
    for name, model, prefix, jfn, tfn, jcfg_fn in (
            ("text_encoder", text, "roberta.", jconvert.convert_text_encoder,
             convert.convert_text_encoder, jconvert.text_config_from_hf),
            ("audio_encoder", audio, "wav2vec2_bert.",
             jconvert.convert_audio_encoder, convert.convert_audio_encoder,
             jconvert.audio_config_from_hf)):
        sd = _np(model, prefix if prefixed else "")
        jcfg = jcfg_fn(model.config)
        want = bridge.flax_to_state_dict({name: jfn(sd, jcfg)})
        got = tfn(sd, port_cfg(jcfg))
        assert set(got) == {k[len(name) + 1:] for k in want}
        for k, v in got.items():
            assert v.dtype == torch.float32
            assert torch.equal(v, want[f"{name}.{k}"]), k
    assert "masked_spec_embed" in got


def test_configs_from_hf_equal_jax(hf):
    text, audio = hf
    assert convert.text_config_from_hf(text.config) == port_cfg(
        jconvert.text_config_from_hf(text.config))
    assert convert.audio_config_from_hf(audio.config) == port_cfg(
        jconvert.audio_config_from_hf(audio.config))


@pytest.fixture(scope="module")
def converted(hf):
    return convert_checkpoint.build_converted_params(
        *hf, HEADS, seed=3, dtype="float32", device="cpu")


def test_encoders_match_the_hf_forward(hf, converted):
    text, audio = hf
    _, model = converted
    rng = np.random.default_rng(2)
    ids = rng.integers(2, 120, size=(3, 12))
    mask = np.zeros((3, 12), np.int64)
    for i, n in enumerate((12, 7, 5)):
        mask[i, :n] = 1
        ids[i, n:] = 1                                  # the pad token
    feats = rng.normal(size=(2, 20, 16)).astype(np.float32)
    amask = np.zeros((2, 20), np.int64)
    amask[0], amask[1, :13] = 1, 1
    with torch.no_grad():
        ref_t = text(input_ids=torch.tensor(ids),
                     attention_mask=torch.tensor(mask)).last_hidden_state
        ref_a = audio(input_features=torch.tensor(feats),
                      attention_mask=torch.tensor(amask)).last_hidden_state
        got_t = model.text_encoder(torch.tensor(ids), torch.tensor(mask))
        got_a = model.audio_encoder(torch.tensor(feats), torch.tensor(amask))
    for got, ref, m in ((got_t, ref_t, mask), (got_a, ref_a, amask)):
        valid = m.astype(bool)
        np.testing.assert_allclose(got.numpy()[valid], ref.numpy()[valid],
                                   rtol=1e-3, atol=3e-4)


def test_heads_come_from_the_seed_and_the_encoders_from_hf(hf, converted):
    cfg, model = converted
    fresh = init_model(cfg.model, torch.Generator().manual_seed(3),
                       train=True)
    own = fresh.state_dict()
    for k, v in model.state_dict().items():
        if k.startswith(("text_encoder.", "audio_encoder.")):
            continue
        assert torch.equal(v, own[k]), k
    assert torch.equal(model.audio_encoder.masked_spec_embed,
                       hf[1].masked_spec_embed.detach())


def test_cli_hf_path_writes_a_checkpoint_serving_and_training_load(
        hf, tmp_path, monkeypatch):
    import transformers
    by_name = {"tiny-xlmr": hf[0], "tiny-w2vbert": hf[1]}
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained",
                        lambda name: by_name[name])
    out = str(tmp_path / "converted")
    res = convert_checkpoint.main([
        "--text-model", "tiny-xlmr", "--audio-model", "tiny-w2vbert",
        "--projection-dim", "24", "--device", "cpu", "--output", out])
    meta = checkpoints.load_metadata(out)
    assert meta["kind"] == checkpoints.KIND and meta["info"] == {
        "text_model": "tiny-xlmr", "audio_model": "tiny-w2vbert"}
    cfg = res["cfg"]
    assert cfg.model.heads.projection_dim == 24 and cfg.model.dtype == \
        "bfloat16"
    emb = Embedder.from_checkpoint(out, device="cpu")
    te = emb.embed_texts(["uma frase qualquer"])
    ae = emb.embed_audios([np.random.default_rng(0).normal(
        scale=0.05, size=16000).astype(np.float32)])
    for e in (te, ae):
        assert e.shape == (1, 24)
        np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, rtol=1e-3)
    # train.init_checkpoint: the loop's check, then its load into the
    # training form of the checkpoint's own config
    tcfg = cfg.with_overrides({"train": {"init_checkpoint": out,
                                         "output_dir": str(tmp_path / "run")}})
    loop.check_supported(tcfg, torch.device("cpu"))
    model = init_model(tcfg.model, torch.Generator().manual_seed(0),
                       train=True)
    checkpoints.load_into(out, model)
    sd = model.state_dict()
    for k, v in convert.convert_text_encoder(
            hf[0].state_dict(), cfg.model.text).items():
        assert torch.equal(sd[f"text_encoder.{k}"], v), k
