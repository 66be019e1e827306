"""The port's reference-checkpoint ingestion (``models/ingest_torch.py``,
``convert_checkpoint.py --from-torch``) against the JAX package's, on the
reference-layout checkpoint that tests/test_ingest_torch.py builds (tiny
HF encoders and torch head modules with the reference trainer's names):
the sniffed config equals JAX's, and every tensor equals JAX's
``params_from_reference_checkpoint`` carried through
``bridge.flax_to_state_dict``, exactly: with fusion and alignment, without
them, and for a model.py-era checkpoint (no ``*_seq_to_projection``: an
identity map). ``--from-torch`` writes a port checkpoint holding those
tensors, which serving loads."""

import numpy as np
import pytest
import torch

from speech_transcript_embeddings_tpu.models import ingest_torch as jingest
from speech_transcript_embeddings_torch import bridge, checkpoints
from speech_transcript_embeddings_torch import convert_checkpoint
from speech_transcript_embeddings_torch.inference.embed import Embedder
from speech_transcript_embeddings_torch.models import ingest_torch
from test_ingest_torch import (  # noqa: F401  (the fixture)
    _torch_pooling, _torch_projection, _TorchAlignment, _TorchCrossModal,
    reference_ckpt,
)
from torch_port_cfg import port_cfg
from torch_port_cfg import one_thread  # noqa: F401


def _heads_only_projection(ckpt, d):
    """The reference checkpoint with fresh heads of projection width ``d``
    (text and audio hidden are 32) and no ``*_seq_to_projection``: the
    reference's inference-variant model."""
    torch.manual_seed(4)
    sd = {k: v for k, v in ckpt["model_state_dict"].items()
          if k.startswith(("text_encoder.", "audio_encoder."))}
    heads = {"text_projection": _torch_projection(32, d),
             "audio_projection": _torch_projection(32, d),
             "text_pooling": torch.nn.Module(),
             "audio_pooling": torch.nn.Module(),
             "text_to_audio_attention": _TorchCrossModal(d),
             "audio_to_text_attention": _TorchCrossModal(d),
             "word_level_alignment": _TorchAlignment(32, 32, d),
             "text_fusion": torch.nn.Sequential(torch.nn.Linear(2 * d, d),
                                                torch.nn.LayerNorm(d)),
             "audio_fusion": torch.nn.Sequential(torch.nn.Linear(2 * d, d),
                                                 torch.nn.LayerNorm(d))}
    heads["text_pooling"].attention = _torch_pooling(32)
    heads["audio_pooling"].attention = _torch_pooling(32)
    for name, m in heads.items():
        for k, v in m.state_dict().items():
            sd[f"{name}.{k}"] = v
    return {**ckpt, "model_state_dict": sd, "projection_dim": d}


def _variant(ckpt, name):
    if name == "fusion_and_alignment":
        return ckpt
    if name == "no_fusion_no_alignment":
        return {**ckpt, "use_cross_modal": False, "use_word_alignment": False}
    return _heads_only_projection(ckpt, 32)


def test_sniffed_config_equals_jax(reference_ckpt):
    ckpt, _ = reference_ckpt
    bare = {"model_state_dict": ckpt["model_state_dict"]}
    for c in (ckpt, bare):
        assert ingest_torch.sniff_reference_config(c) == port_cfg(
            jingest.sniff_reference_config(c))


@pytest.mark.parametrize("variant", ["fusion_and_alignment",
                                     "no_fusion_no_alignment",
                                     "model_py_identity"])
def test_state_dict_equals_jax_through_the_bridge(reference_ckpt, variant):
    ckpt = _variant(reference_ckpt[0], variant)
    jcfg = jingest.sniff_reference_config(ckpt)
    want = bridge.flax_to_state_dict(
        jingest.params_from_reference_checkpoint(ckpt, jcfg))
    got = ingest_torch.state_dict_from_reference_checkpoint(
        ckpt, port_cfg(jcfg))
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    if variant == "model_py_identity":
        assert torch.equal(got["text_seq_to_projection.weight"],
                           torch.eye(32))


def test_a_missing_projection_map_of_another_width_is_refused(
        reference_ckpt):
    ckpt = dict(reference_ckpt[0])
    ckpt["model_state_dict"] = {
        k: v for k, v in ckpt["model_state_dict"].items()
        if "seq_to_projection" not in k}
    cfg = ingest_torch.sniff_reference_config(ckpt)
    with pytest.raises(ValueError, match="hidden 32 != projection 24"):
        ingest_torch.state_dict_from_reference_checkpoint(ckpt, cfg)


def test_from_torch_cli_round_trip(reference_ckpt, tmp_path):
    ckpt, _ = reference_ckpt
    pt = str(tmp_path / "best_model_gap.pt")
    torch.save(ckpt, pt)
    out = str(tmp_path / "ingested")
    res = convert_checkpoint.main(["--from-torch", pt, "--output", out])
    assert checkpoints.load_metadata(out)["info"]["kind_detail"] == \
        "reference_torch"
    assert res["cfg"] == port_cfg(jingest.sniff_reference_config(ckpt))
    stored = checkpoints.load_stored_state(out)
    want = ingest_torch.state_dict_from_reference_checkpoint(ckpt, res["cfg"])
    assert set(stored) == set(want) and all(
        torch.equal(stored[k], v) for k, v in want.items())
    served = Embedder.from_checkpoint(out, device="cpu")
    te = served.embed_texts(["uma frase qualquer", "outra"])
    ae = served.embed_audios([np.random.default_rng(0).normal(
        scale=0.05, size=16000).astype(np.float32)])
    for e, n in ((te, 2), (ae, 1)):
        assert e.shape == (n, 24) and np.isfinite(e).all()
        np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, rtol=1e-3)
